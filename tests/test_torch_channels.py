"""Channel scoring, the α-quantile and the exact edge rule of the port
against ``repro.core.channels`` / ``repro.core.selection`` on the CPU
(where the port's kernel wrappers run their plain versions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as ref_wire
from repro.core import channels as ref_ch
from repro.core import selection as ref_sel
from repro_torch.comm import wire as port_wire
from repro_torch.core import channels as port_ch
from repro_torch.core import selection as port_sel
from repro_torch.core.client import client_delta, local_train_impl
from repro_torch.data.medical import federated_split, generate_cohort
from repro_torch.models.mlp_net import init_mlp
from repro_torch.params import from_numpy, to_numpy

from _torch_parity import np_tree

FEATS = (40, 24, 12, 1)


def _grads(seed=0, feats=FEATS, dead=()):
    """A delta with a few dead neurons (zero gradient columns)."""
    rng = np.random.default_rng(seed)
    g = []
    for l, (fin, fout) in enumerate(zip(feats[:-1], feats[1:])):
        w = (rng.standard_normal((fin, fout)) * 1e-2).astype(np.float32)
        b = (rng.standard_normal(fout) * 1e-2).astype(np.float32)
        for (dl, j) in dead:
            if dl == l:
                w[:, j] = 0.0
                b[j] = 0.0
        g.append({"w": w, "b": b})
    return tuple(g)


def _jax(tree):
    return tuple({k: jnp.asarray(v) for k, v in l.items()} for l in tree)


def _keep_masks(feats, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.random(f) < 0.8).astype(np.float32) for f in feats[1:-1]]


@pytest.mark.parametrize("mode", ["plain", "normalized", "masked"])
def test_layer_scores_match(mode):
    g = _grads()
    nm = _keep_masks(FEATS) if mode == "masked" else None
    want = ref_ch.layer_scores(
        _jax(g), normalize=mode == "normalized",
        neuron_masks=None if nm is None else [jnp.asarray(m) for m in nm])
    got = port_ch.layer_scores(
        from_numpy(g, "cpu"), normalize=mode == "normalized",
        neuron_masks=None if nm is None else [torch.from_numpy(m)
                                              for m in nm])
    for s_got, s_want in zip(got, want):
        assert s_got.dtype == torch.float32
        np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want),
                                   rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("selection,rate", [("positive", 0.1),
                                            ("positive", 0.5),
                                            ("negative", 0.3)])
def test_exact_channel_quantile_matches(masked, selection, rate):
    s = ref_ch.layer_scores(
        _jax(_grads(2)),
        neuron_masks=[jnp.asarray(m) for m in _keep_masks(FEATS)]
        if masked else None)
    want = ref_ch.channel_quantile(s, rate, selection=selection,
                                   masked=masked)
    got = port_ch.channel_quantile([torch.tensor(np.asarray(v))
                                    for v in s], rate, selection=selection,
                                   masked=masked)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_sampled_channel_quantile_with_injected_indices(masked):
    # 256 * 128 * 129 channels > MAX_MATERIALIZED: the stochastic path
    rng = np.random.default_rng(3)
    sizes = (256, 128, 129)
    assert np.prod(sizes) > ref_ch.MAX_MATERIALIZED
    s = [rng.random(n).astype(np.float32) for n in sizes]
    if masked:
        s[0][::3] = -np.inf
    key = jax.random.PRNGKey(11)
    want = ref_ch.channel_quantile([jnp.asarray(v) for v in s], 0.1,
                                   key=key, masked=masked)
    # the reference's draws, as channel_quantile makes them
    idx = []
    for k, v in zip(jax.random.split(key, len(s)), s):
        if masked:
            logits = jnp.where(jnp.isfinite(jnp.asarray(v)), 0.0, -jnp.inf)
            idx.append(np.asarray(jax.random.categorical(k, logits,
                                                         shape=(1 << 16,))))
        else:
            idx.append(np.asarray(jax.random.randint(k, (1 << 16,), 0,
                                                     v.shape[0])))
    got = port_ch.channel_quantile([torch.from_numpy(v) for v in s], 0.1,
                                   sample_idx=idx, masked=masked)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # without injected draws the port samples on its own generator
    drawn = port_ch.channel_quantile([torch.from_numpy(v) for v in s], 0.1,
                                     generator=torch.Generator()
                                     .manual_seed(0), masked=masked)
    assert abs(float(drawn) - float(want)) < 0.05


@pytest.mark.parametrize("seed,rate", [(0, 0.1), (4, 0.3), (5, 0.05)])
def test_apply_channel_mask_matches_exactly(seed, rate):
    g = _grads(seed, dead=[(0, 3), (1, 5)])
    s = ref_ch.layer_scores(_jax(g))
    thr = ref_ch.channel_quantile(s, rate)
    want_g, want_m = ref_ch.apply_channel_mask(_jax(g), s, thr)
    got_g, got_m = port_ch.apply_channel_mask(
        from_numpy(g, "cpu"), [torch.tensor(np.asarray(v)) for v in s],
        torch.tensor(float(thr)))
    for lg, lw in zip(np_tree(got_g), np_tree(want_g)):
        for k in lw:
            assert lg[k].tobytes() == lw[k].tobytes()
    for lg, lw in zip(np_tree(got_m), np_tree(want_m)):
        for k in lw:
            assert np.array_equal(lg[k], lw[k]), k


def test_apply_channel_mask_ties_at_the_threshold():
    """A threshold equal to a channel total: only strictly greater passes,
    in both packages."""
    g = _grads(6)
    s = ref_ch.layer_scores(_jax(g))
    t = np.sort(np.asarray(ref_ch.materialize_channel_tensor(s)).ravel())
    thr = jnp.float32(t[int(0.8 * t.size)])
    _, want_m = ref_ch.apply_channel_mask(_jax(g), s, thr)
    _, got_m = port_ch.apply_channel_mask(
        from_numpy(g, "cpu"), [torch.tensor(np.asarray(v)) for v in s],
        torch.tensor(float(thr)))
    for lg, lw in zip(np_tree(got_m), np_tree(want_m)):
        for k in lw:
            assert np.array_equal(lg[k], lw[k]), k


@pytest.mark.parametrize("selection", ["positive", "negative"])
def test_select_gradients_end_to_end(selection):
    g = _grads(7, dead=[(1, 2)])
    want_g, want_m, want_t = ref_sel.select_gradients(_jax(g), 0.1,
                                                      selection)
    got_g, got_m, got_t, _ = port_sel.select_gradients(
        from_numpy(g, "cpu"), 0.1, selection)
    np.testing.assert_allclose(float(got_t), float(want_t), rtol=1e-6)
    for lg, lw in zip(np_tree(got_m), np_tree(want_m)):
        for k in lw:
            assert np.array_equal(lg[k], lw[k]), k
    for lg, lw in zip(np_tree(got_g), np_tree(want_g)):
        for k in lw:
            assert lg[k].tobytes() == lw[k].tobytes()
    ws = ref_sel.UploadStats.from_masks(want_m)
    gs = port_sel.UploadStats.from_masks(got_m)
    assert dataclasses.astuple(gs) == dataclasses.astuple(ws)


def test_max_completion_and_num_channels():
    s = [torch.tensor([1.0, 3.0]), torch.tensor([2.0]), torch.tensor([0.5])]
    assert float(port_ch.max_completion(s)) == 5.5
    assert port_ch.num_channels(s) == 2
    t = port_ch.materialize_channel_tensor(s)
    assert t.shape == (2, 1, 1) and t.reshape(-1).tolist() == [3.5, 5.5]


def test_full_width_selection_matches_reference():
    """The main path's shapes — W (2917,256), (256,64), (64,1) — on a
    delta from real local training (one client of a 4,000-admission
    cohort with all 2,917 medications, 2 epochs): both packages select
    the same masks, and give the same UploadStats and wire payload.  The
    channel tensor has 256·64·1 = 16,384 channels, below
    ``MAX_MATERIALIZED``, so the threshold is the exact quantile — no
    sampled draws.  The upload fraction is ~0.98 at α = 0.10 in both:
    the layer-0 rule reveals a whole W0 column for every first-layer
    neuron on a selected channel, and W0 is 98% of the parameters."""
    cohort = generate_cohort(num_admissions=4000, seed=0)
    x, y = federated_split(cohort.x_train, cohort.y_train, 5, seed=0)[0]
    params = init_mlp((cohort.num_features, 256, 64, 1),
                      torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    new = local_train_impl(params, torch.from_numpy(x), torch.from_numpy(y),
                           0.01, perms=[rng.permutation(len(y))
                                        for _ in range(2)],
                           batch_size=256, epochs=2)
    g = client_delta(params, new)
    assert [tuple(l["w"].shape) for l in g] == [(2917, 256), (256, 64),
                                                (64, 1)]
    got_g, got_m, got_t, ops = port_sel.select_gradients(g, 0.1)
    want_g, want_m, want_t = ref_sel.select_gradients(_jax(to_numpy(g)),
                                                      0.1)
    assert float(got_t) == float(want_t)
    for lg, lw in zip(np_tree(got_m), np_tree(want_m)):
        for k in lw:
            assert np.array_equal(lg[k], lw[k]), k
    gs = port_sel.UploadStats.from_masks(got_m)
    ws = ref_sel.UploadStats.from_masks(want_m)
    assert dataclasses.astuple(gs) == dataclasses.astuple(ws)
    assert 0.97 < gs.upload_fraction < 0.99
    got = port_wire.encode_selected(got_g, ops)
    want = ref_wire.encode(want_g)
    assert got.nbytes == want.nbytes
    for a, b in zip(got.layers, want.layers):
        assert (a.codec, a.nnz) == (b.codec, b.nnz)
        assert a.values.tobytes() == b.values.tobytes()
