"""Wire codecs, upload accounting and the server's payload sum of the port
against ``repro.comm.wire`` / ``repro.core.selection`` on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as ref_wire
from repro.core import selection as ref_sel
from repro_torch.comm import wire as port_wire
from repro_torch.core import channels as port_ch
from repro_torch.core import selection as port_sel
from repro_torch.core import server as port_server
from repro_torch.core.pruning import index_tensors
from repro_torch.fed.engine import _compact_layers, _compact_operands
from repro_torch.kernels import select_mask as sm
from repro_torch.params import from_numpy

from _torch_parity import np_tree

FEATS = (30, 20, 10, 1)


def _masked_delta(seed, density):
    rng = np.random.default_rng(seed)
    out = []
    for fin, fout in zip(FEATS[:-1], FEATS[1:]):
        layer = {}
        for k, shape in (("w", (fin, fout)), ("b", (fout,))):
            v = rng.standard_normal(shape).astype(np.float32)
            v[rng.random(shape) >= density] = 0.0
            layer[k] = v
        out.append(layer)
    return tuple(out)


def _assert_same_payload(got, want):
    assert len(got.layers) == len(want.layers)
    for g, w in zip(got.layers, want.layers):
        assert (g.codec, tuple(g.shape), g.dtype, g.nnz, g.nbytes) == \
            (w.codec, tuple(w.shape), w.dtype, w.nnz, w.nbytes)
        for name in ("idx", "bitmap"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b)
        assert g.values.tobytes() == w.values.tobytes()
    assert got.nbytes == want.nbytes
    assert got.dense_nbytes == want.dense_nbytes


@pytest.mark.parametrize("density", [0.02, 0.3, 0.95])
@pytest.mark.parametrize("codec", ["auto", "coo", "bitmap", "dense"])
def test_encode_matches_reference_leaf_by_leaf(density, codec):
    delta = _masked_delta(0, density)
    want = ref_wire.encode(delta, codec)
    got = port_wire.encode(from_numpy(delta, "cpu"), codec)
    # leaves in JAX's flatten order: layers in order, keys sorted
    assert got.keys == ((0, "b"), (0, "w"), (1, "b"), (1, "w"),
                        (2, "b"), (2, "w"))
    _assert_same_payload(got, want)
    back = port_wire.decode(got)
    for lg, lw in zip(np_tree(back), delta):
        for k in lw:
            assert lg[k].tobytes() == lw[k].tobytes()


def test_auto_codec_picks_all_three_at_some_density():
    seen = set()
    for density in (0.02, 0.3, 0.95):
        seen |= {lp.codec for lp in port_wire.encode(
            from_numpy(_masked_delta(1, density), "cpu")).layers}
    assert seen == {"coo", "bitmap", "dense"}


def test_apply_payloads_mixed_codecs_matches_reference_exactly():
    params = _masked_delta(9, 1.0)
    clients = [(_masked_delta(10, 0.05), "coo"),
               (_masked_delta(11, 0.4), "bitmap"),
               (_masked_delta(12, 0.9), "dense"),
               (_masked_delta(13, 0.1), "auto")]
    want = ref_wire.apply_payloads(
        params, [ref_wire.encode(d, c) for d, c in clients])
    got = port_wire.apply_payloads(
        from_numpy(params, "cpu"),
        [port_wire.encode(from_numpy(d, "cpu"), c) for d, c in clients])
    for lg, lw in zip(np_tree(got), np_tree(want)):
        for k in lw:
            assert lg[k].tobytes() == lw[k].tobytes(), k
    via_server = port_server.scbf_update(
        from_numpy(params, "cpu"),
        payloads=[port_wire.encode(from_numpy(d, "cpu"), c)
                  for d, c in clients])
    for lg, lw in zip(np_tree(via_server), np_tree(got)):
        for k in lw:
            assert np.array_equal(lg[k], lw[k])


def test_kept_zero_counts_in_stats_but_costs_no_bytes():
    """Mask counts reveal (UploadStats); the wire keeps nonzeros (bytes):
    a kept entry that is exactly zero shows in the first, not the second."""
    delta = _masked_delta(3, 0.2)
    masks = tuple({k: v != 0 for k, v in layer.items()} for layer in delta)
    delta[0]["w"][masks[0]["w"]] = np.where(
        np.arange(int(masks[0]["w"].sum())) % 3 == 0, 0.0,
        delta[0]["w"][masks[0]["w"]])
    ref_stats = ref_sel.UploadStats.from_masks(
        tuple({k: jnp.asarray(v) for k, v in m.items()} for m in masks))
    port_stats = port_sel.UploadStats.from_masks(
        tuple({k: torch.from_numpy(v) for k, v in m.items()}
              for m in masks))
    assert dataclasses.astuple(port_stats) == dataclasses.astuple(ref_stats)
    want = ref_wire.encode(delta)
    got = port_wire.encode(from_numpy(delta, "cpu"))
    _assert_same_payload(got, want)
    assert got.layers[1].nnz < int(masks[0]["w"].sum())


def test_validation_refuses_corrupt_payloads():
    params = from_numpy(_masked_delta(4, 1.0), "cpu")
    good = port_wire.encode(from_numpy(_masked_delta(5, 0.05), "cpu"), "coo")
    lp = good.layers[1]
    for bad in (dataclasses.replace(lp, idx=lp.idx + 10 ** 6),
                dataclasses.replace(lp, idx=np.repeat(lp.idx[:1], lp.nnz)),
                dataclasses.replace(lp, codec="zip"),
                dataclasses.replace(lp, shape=(1, 2))):
        payload = dataclasses.replace(
            good, layers=good.layers[:1] + (bad,) + good.layers[2:])
        with pytest.raises(port_wire.PayloadError):
            port_wire.apply_payloads(params, [payload])
    with pytest.raises(port_wire.PayloadError):
        port_wire.apply_payloads(params, [dataclasses.replace(
            good, layers=good.layers[:2])])
    port_wire.validate_payload(good, params)


def _selected_delta(seed, density):
    """A delta, its edge operands (thresholds at ``density`` of the pair
    sums — all of them at 1 — rest 0.1) and the select-mask output.  Every fourth row of W0 is
    exactly zero — a medication no example in the batches takes — so many
    kept entries are zeros that the wire must not ship."""
    rng = np.random.default_rng(seed)
    g = []
    for l, (fin, fout) in enumerate(zip(FEATS[:-1], FEATS[1:])):
        w = rng.standard_normal((fin, fout)).astype(np.float32)
        if l == 0:
            w[::4] = 0.0
            w[rng.random(w.shape) < 0.05] = 0.0
        g.append({"w": w, "b": rng.standard_normal(fout).astype(np.float32)})
    g = from_numpy(tuple(g), "cpu")
    ops = []
    for l, layer in enumerate(g):
        m, n = layer["w"].shape
        row = torch.from_numpy(rng.random(m).astype(np.float32)) if l \
            else torch.zeros(m)
        col = torch.from_numpy(rng.random(n).astype(np.float32))
        rest = torch.tensor(0.1)
        pairs = ((row[:, None] + col[None, :]) + rest).reshape(-1)
        thr = torch.quantile(pairs, 1.0 - density) if density < 1 \
            else pairs.min() - 1.0
        ops.append(port_ch.EdgeOperands(layer["w"], row, col, thr, rest))
    masked, _ = port_ch.mask_by_operands(g, ops)
    return masked, ops


@pytest.mark.parametrize("density", [0.02, 0.3, 1.0])
def test_encode_selected_equals_encode_byte_for_byte(density):
    """The device encoder (the select-compact kernel's plain version on
    the CPU) gives the host encoder's payload, and the reference's, field
    for field — with kept-but-zero entries dropped as the wire drops
    them."""
    masked, ops = _selected_delta(20, density)
    sm.reset_launches()
    got = port_wire.encode_selected(masked, ops)
    assert sm.compact_count_launches == 0      # CPU: the plain version
    assert sm.compact_scatter_launches == 0
    _assert_same_payload(got, port_wire.encode(masked))
    _assert_same_payload(got, ref_wire.encode(np_tree(masked)))
    kept = int(sm.select_mask(*ops[0])[2])
    assert got.layers[1].nnz < kept or kept == 0   # zeros were selected


def test_encode_selected_picks_all_three_codecs():
    seen = set()
    for density in (0.02, 0.3, 1.0):
        masked, ops = _selected_delta(21, density)
        seen |= {lp.codec for (_, k), lp in zip(
            *(lambda p: (p.keys, p.layers))(
                port_wire.encode_selected(masked, ops))) if k == "w"}
    assert seen == {"coo", "bitmap", "dense"}


def test_encode_selected_from_the_selection_pipeline():
    """select_gradients' operands feed the encoder on the main path."""
    rng = np.random.default_rng(22)
    g = tuple({"w": rng.standard_normal((fin, fout)).astype(np.float32)
               * (rng.random((fin, 1)) < 0.7),
               "b": rng.standard_normal(fout).astype(np.float32)}
              for fin, fout in zip(FEATS[:-1], FEATS[1:]))
    masked, _, _, ops = port_sel.select_gradients(from_numpy(g, "cpu"), 0.1)
    want, _, _ = ref_sel.select_gradients(
        tuple({k: jnp.asarray(v) for k, v in l.items()} for l in g), 0.1)
    got = port_wire.encode_selected(masked, ops)
    _assert_same_payload(got, ref_wire.encode(want))


def test_encode_selected_in_effective_geometry():
    """Mask-mode emission: slicing the operands by the keep sets on the
    device and compacting gives the payload of the sliced masked delta."""
    masked, ops = _selected_delta(23, 0.3)
    keep = index_tensors([np.array([0, 3, 4, 9, 15, 19]),
                          np.array([1, 2, 7])], "cpu")
    eff = _compact_layers(masked, keep)
    assert [tuple(l["w"].shape) for l in eff] == [(30, 6), (6, 3), (3, 1)]
    got = port_wire.encode_selected(eff, _compact_operands(ops, keep))
    _assert_same_payload(got, ref_wire.encode(np_tree(eff)))


@pytest.mark.parametrize("case", ["dense_w0", "signed_zeros", "all_zero"])
def test_encode_selected_count_first_matches_encode(case):
    """The count-first encoder (count every weight leaf, pick the codecs,
    compact only the coo and bitmap leaves at their counts) gives
    ``encode``'s payload and the reference's byte for byte: a W0 every
    entry of which is kept and almost all nonzero (dense wins, nothing
    scattered for it), kept entries that are -0.0 or +0.0 (the wire drops
    both), and a leaf that keeps nothing (coo with no entry)."""
    rng = np.random.default_rng(24)
    g = []
    for fin, fout in zip(FEATS[:-1], FEATS[1:]):
        g.append({"w": rng.standard_normal((fin, fout)).astype(np.float32),
                  "b": rng.standard_normal(fout).astype(np.float32)})
    if case == "signed_zeros":
        g[0]["w"][::4] = -0.0
        g[1]["w"][1::3] = 0.0
    else:
        g[0]["w"][0, 0] = -0.0          # one zero: dense still wins
    g = from_numpy(tuple(g), "cpu")
    ops = []
    for l, layer in enumerate(g):
        m, n = layer["w"].shape
        row = torch.zeros(m) if l == 0 else \
            torch.from_numpy(rng.random(m).astype(np.float32))
        col = torch.from_numpy(rng.random(n).astype(np.float32))
        pairs = (row[:, None] + col[None, :]).reshape(-1)
        if l == 0 or case == "signed_zeros":
            thr = pairs.min() - 1.0              # everything kept
        elif case == "all_zero" and l == 2:
            thr = pairs.max() + 1.0              # nothing kept
        else:
            thr = torch.quantile(pairs, 0.7)
        ops.append(port_ch.EdgeOperands(layer["w"], row, col, thr,
                                        torch.tensor(0.0)))
    masked, _ = port_ch.mask_by_operands(g, ops)
    got = port_wire.encode_selected(masked, ops)
    _assert_same_payload(got, port_wire.encode(masked))
    _assert_same_payload(got, ref_wire.encode(np_tree(masked)))
    codecs = [lp.codec for (_, k), lp in zip(got.keys, got.layers)
              if k == "w"]
    if case == "signed_zeros":
        assert codecs[0] == "bitmap" and got.layers[1].nnz == 22 * 20
    else:
        assert codecs[0] == "dense"
    if case == "all_zero":
        assert codecs[2] == "coo" and got.layers[5].nnz == 0


def _selected_round(densities, seed):
    """A slot-stacked round, slot s a ``_selected_delta`` at
    ``densities[s]``: (masked, operands) as the engine's emission gives
    them (every operand with its slot dimension)."""
    slots = [_selected_delta(seed + s, d) for s, d in enumerate(densities)]
    masked = tuple({k: torch.stack([m[l][k] for m, _ in slots])
                    for k in slots[0][0][l]}
                   for l in range(len(slots[0][0])))
    ops = [port_ch.EdgeOperands(*(torch.stack([o[l][f] for _, o in slots])
                                  for f in range(5)))
           for l in range(len(slots[0][1]))]
    return masked, ops


@pytest.mark.parametrize("case", ["bitmap_only", "coo_only", "mixed",
                                  "slot_groups", "one_slot"])
def test_encode_round_wire_forms_match_encode(monkeypatch, case):
    """The scatter writes a bitmap pair in its wire form (the packed
    bitmap, then the values) and a coo pair as indices and values; the
    payloads built on views of the buffer are ``encode``'s and the
    reference's field for field and seal to their checksums; the bitmap
    pairs are counted (none in a coo-only round) — in one launch of coo
    and bitmap pairs, and in a round split over ``slot_groups``."""
    densities = {"bitmap_only": [0.3, 0.4, 0.3], "coo_only": [0.02] * 3,
                 "mixed": [0.02, 0.3, 1.0, 0.3], "slot_groups": [0.3] * 5,
                 "one_slot": [0.3]}[case]
    masked, ops = _selected_round(densities, 30)
    if case == "coo_only":          # W2 (10 x 1) keeps nothing: one kept
        ops[2] = ops[2]._replace(thr=ops[2].thr + 10.0)   # would be bitmap
        masked[2]["w"].zero_()
    if case == "slot_groups":
        monkeypatch.setattr(sm, "MAX_SLOTS", 4)
        assert port_ch.slot_groups(5, 3) == [(s, s + 1) for s in range(5)]
    sm.reset_launches()
    if case == "one_slot":
        got = [port_wire.encode_selected(
            tuple({k: v[0] for k, v in layer.items()} for layer in masked),
            [port_ch.EdgeOperands(*(t[0] for t in op)) for op in ops])]
    else:
        got = port_wire.encode_round(masked, ops, len(densities))
    assert len(got) == len(densities)
    bitmaps = 0
    for s, payload in enumerate(got):
        one = tuple({k: v[s] for k, v in layer.items()} for layer in masked)
        want = ref_wire.encode(np_tree(one))
        _assert_same_payload(payload, port_wire.encode(one))
        _assert_same_payload(payload, want)
        assert port_wire.seal(payload, s, 7).meta.checksum == \
            ref_wire.seal(want, s, 7).meta.checksum
        bitmaps += sum(lp.codec == "bitmap" for (_, k), lp in
                       zip(payload.keys, payload.layers) if k == "w")
    assert sm.compact_bitmap_pairs == bitmaps
    if case == "coo_only":
        assert bitmaps == 0
    elif case == "mixed":
        codecs = {lp.codec for p in got for (_, k), lp in
                  zip(p.keys, p.layers) if k == "w"}
        assert codecs == {"coo", "bitmap", "dense"}
    else:
        assert bitmaps >= len(densities)
