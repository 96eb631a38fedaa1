"""APoZ pruning of the port (``repro_torch.core.pruning``) against
``repro.core.pruning`` on the CPU, from the same numpy params and
validation set.  Scores and keep sets are compared bitwise: ties decide
which neurons go."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as ref_wire
from repro.core import pruning as ref_pr
from repro_torch.comm import wire as port_wire
from repro_torch.core import pruning as port_pr
from repro_torch.models.mlp_net import hidden_sizes
from repro_torch.params import from_numpy

from _torch_parity import np_tree


def _params(feats, seed=0, dead=3):
    """He-scaled weights with negative biases (many exact zeros after the
    ReLU) and ``dead`` always-off neurons per hidden layer (APoZ 1.0
    ties)."""
    rng = np.random.default_rng(seed)
    out = []
    for l, (fin, fout) in enumerate(zip(feats[:-1], feats[1:])):
        w = (rng.standard_normal((fin, fout)) * np.sqrt(2.0 / fin)
             ).astype(np.float32)
        b = (rng.standard_normal(fout) * 0.5 - 0.3).astype(np.float32)
        if l < len(feats) - 2:
            off = rng.choice(fout, min(dead, fout // 2), replace=False)
            b[off] = -100.0
        out.append({"w": w, "b": b})
    return tuple(out)


def _x(n, d, seed=1):
    return (np.random.default_rng(seed).random((n, d)) < 0.2
            ).astype(np.float32)


def _jax(tree):
    return tuple({k: jnp.asarray(v) for k, v in l.items()} for l in tree)


def _bits(a):
    return np.asarray(a, np.float32).tobytes()


@pytest.mark.parametrize("feats,n_val,batch,masked", [
    ((30, 24, 12, 1), 300, 128, False),      # tail batch of 44
    ((30, 24, 12, 1), 300, 128, True),       # keep-masks
    ((30, 24, 12, 1), 90, 2048, False),      # smaller than one batch
    ((20, 256, 16, 1), 1100, 512, False),    # the reference's Pallas path
], ids=["tail", "masked", "one-batch", "pallas-shapes"])
def test_apoz_scores_match_reference_bitwise(feats, n_val, batch, masked):
    params = _params(feats)
    x = _x(n_val, feats[0])
    nm = None
    if masked:
        rng = np.random.default_rng(5)
        nm = [(rng.random(h) < 0.7).astype(np.float32) for h in feats[1:-1]]
    want = ref_pr.apoz_scores(
        _jax(params), x, batch_size=batch,
        neuron_masks=None if nm is None else tuple(jnp.asarray(m)
                                                   for m in nm))
    got = port_pr.apoz_scores(
        from_numpy(params, "cpu"), torch.from_numpy(x), batch_size=batch,
        neuron_masks=None if nm is None else tuple(torch.from_numpy(m)
                                                   for m in nm))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        assert _bits(g) == _bits(w)
    assert any(np.any(g == 1.0) for g in got)     # the dead neurons tie


def test_apoz_scores_refuse_an_empty_validation_set():
    with pytest.raises(ValueError, match="non-empty"):
        port_pr.apoz_scores(from_numpy(_params((8, 4, 2, 1)), "cpu"),
                            np.zeros((0, 8), np.float32))


def _tied_apoz(seed=2):
    rng = np.random.default_rng(seed)
    a = [np.round(rng.random(24), 1).astype(np.float32),
         np.round(rng.random(12), 1).astype(np.float32)]
    a[1][:3] = 1.0
    return a


@pytest.mark.parametrize("already", [0, 5, 15])
@pytest.mark.parametrize("rate,total", [(0.1, 0.47), (0.5, 0.9),
                                        (0.3, 0.2)])
def test_plan_prune_matches_reference(already, rate, total):
    apoz = _tied_apoz()
    want = ref_pr.plan_prune(apoz, rate, already, 36, total)
    got = port_pr.plan_prune(apoz, rate, already, 36, total)
    assert [k.tolist() for k in got] == [k.tolist() for k in want]
    assert port_pr._step_budget(rate, already, 36, total) == \
        ref_pr._step_budget(rate, already, 36, total)


def test_update_keep_masks_matches_reference_and_never_empties_a_layer():
    apoz = _tied_apoz(3)
    keep = [np.ones(24, bool), np.ones(12, bool)]
    keep[0][::4] = False
    for rate, total in ((0.2, 0.5), (0.9, 0.99), (0.9, 0.99)):
        want = ref_pr.update_keep_masks(apoz, keep, rate, total)
        got = port_pr.update_keep_masks(apoz, keep, rate, total)
        assert [m.tolist() for m in got] == [m.tolist() for m in want]
        assert all(m.any() for m in got)
        keep = got


def test_apply_structure_matches_reference():
    params = _params((10, 8, 6, 1), seed=4)
    keep = [np.array([0, 2, 3, 7]), np.array([1, 5])]
    want = ref_pr.apply_structure(_jax(params), keep)
    got = port_pr.apply_structure(from_numpy(params, "cpu"), keep)
    for lg, lw in zip(np_tree(got), np_tree(want)):
        for name in lw:
            assert lg[name].shape == lw[name].shape
            assert lg[name].tobytes() == lw[name].tobytes()
    assert list(hidden_sizes(got)) == ref_pr.hidden_sizes(want) == [4, 2]


@pytest.mark.parametrize("codec", ["coo", "bitmap", "dense"])
def test_expand_payloads_matches_reference(codec):
    full = _params((10, 8, 6, 1), seed=6)
    keep = [np.array([0, 2, 3, 7]), np.array([1, 5])]
    eff = tuple({k: np.array(v) for k, v in layer.items()}   # writable
                for layer in np_tree(ref_pr.apply_structure(_jax(full),
                                                            keep)))
    rng = np.random.default_rng(7)
    for layer in eff:
        for v in layer.values():
            v[rng.random(v.shape) < 0.5] = 0.0
    want = ref_pr.expand_payloads([ref_wire.encode(eff, codec)], keep,
                                  _jax(full))
    got = port_pr.expand_payloads(
        [port_wire.encode(from_numpy(eff, "cpu"), codec)], keep,
        from_numpy(full, "cpu"))
    for g, w in zip(got[0].layers, want[0].layers):
        assert (g.codec, tuple(g.shape), g.nnz, g.nbytes) == \
            (w.codec, tuple(w.shape), w.nnz, w.nbytes)
        assert np.array_equal(g.idx, w.idx) and g.idx.dtype == w.idx.dtype
        assert g.values.tobytes() == w.values.tobytes()
    # the expanded payload lands the effective values at full geometry
    applied = port_wire.apply_payloads(
        tuple({k: torch.zeros_like(v) for k, v in l.items()}
              for l in from_numpy(full, "cpu")), got)
    back = port_pr.apply_structure(applied, keep)
    for lg, lw in zip(np_tree(back), eff):
        for k in lw:
            assert lg[k].tobytes() == lw[k].tobytes()


@pytest.mark.parametrize("impl,feats,rate,total", [
    ("reshape", (30, 24, 12, 1), 0.2, 0.47),
    ("mask", (30, 24, 12, 1), 0.2, 0.47),
    ("reshape", (30, 2, 2, 1), 0.5, 0.9),     # the never-empty cap stalls
    ("mask", (30, 2, 2, 1), 0.5, 0.9),
])
def test_pruner_trajectory_matches_reference(impl, feats, rate, total):
    """Step the two Pruners on the same (fixed) weights until both stop:
    keep sets, hidden sizes, active/stalled, the compaction and the
    resulting weights agree at every step."""
    params = _params(feats, seed=8, dead=1)
    x = _x(200, feats[0], seed=9)
    kw = dict(prune_rate=rate, prune_total=total, impl=impl, compact=True)
    ref = ref_pr.Pruner(_jax(params), x, **kw)
    port = port_pr.Pruner(from_numpy(params, "cpu"), x, **kw)
    rp, pp = _jax(params), from_numpy(params, "cpu")
    steps = 0
    while ref.active or port.active:
        assert ref.active == port.active
        rp, pp = ref.step(rp), port.step(pp)
        steps += 1
        assert [k.tolist() for k in port.keep] == \
            [k.tolist() for k in ref.keep]
        assert port.hidden_sizes() == ref.hidden_sizes()
        assert port.effective_param_count(pp) == \
            ref.effective_param_count(rp)
        assert port._stalled == ref._stalled
        if impl == "mask":
            assert port.emission_keep is not None
            for pm, rm in zip(port.masks, ref.masks):
                assert pm.dtype == torch.float32
                assert np.array_equal(pm.numpy(), np.asarray(rm))
        assert port.should_compact == ref.should_compact
        if ref.should_compact:
            rp, pp = ref.compact(rp), port.compact(pp)
            assert port.masks is None and port.emission_keep is None
    assert steps >= 2
    assert port.pruned_so_far == ref.pruned_so_far > 0
    for lg, lw in zip(np_tree(pp), np_tree(rp)):
        for k in lw:
            assert lg[k].tobytes() == lw[k].tobytes()


def test_pruner_refuses_an_unknown_impl():
    with pytest.raises(ValueError, match="prune_impl"):
        port_pr.Pruner(from_numpy(_params((8, 4, 2, 1)), "cpu"),
                       _x(10, 8), prune_rate=0.1, prune_total=0.5,
                       impl="drop")
