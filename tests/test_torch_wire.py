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
from repro_torch.core import selection as port_sel
from repro_torch.core import server as port_server
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
