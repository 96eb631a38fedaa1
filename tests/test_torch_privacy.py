"""DP on the upload path: the port's ``core.privacy`` against the
reference's on the CPU — the accountants to 1e-12, refusals included, and
the Gaussian mechanism with the reference's normals injected to rtol
1e-6 — and ``run_federated``'s DP gate against the reference's
refusals."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ScbfConfig as RefScbfConfig
from repro.config import TrainConfig as RefTrainConfig
from repro.core import privacy as ref
from repro.core.scbf import run_federated as ref_run
from repro.data.medical import generate_cohort as ref_cohort
from repro_torch import config as tcfg
from repro_torch.core import privacy as port
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort

from _torch_parity import np_tree, reference_normals


def test_rdp_orders_are_the_references():
    assert port.RDP_ORDERS == ref.RDP_ORDERS
    assert port.SUBSAMPLED_ORDERS == ref.SUBSAMPLED_ORDERS


@pytest.mark.parametrize("fn,args", [
    ("gaussian_rdp", (1.1, 2.5, 3)),
    ("gaussian_rdp", (0.7, 64.0, 1)),
    ("subsampled_gaussian_rdp", (1.1, 0.3, 7, 4)),
    ("subsampled_gaussian_rdp", (0.8, 0.05, 64, 30)),
    ("subsampled_gaussian_rdp", (1.3, 1.0, 5, 2)),
    ("subsampled_gaussian_rdp", (1.3, 0.0, 5, 2)),
    ("amplified_epsilon_for", (1.1, 0.3, 1e-5, 10)),
    ("amplified_epsilon_for", (0.9, 1.0, 1e-6, 5)),
    ("amplified_epsilon_for", (1.0, 0.6, 1e-5, 0)),
    ("amplified_epsilon_for", (0.0, 0.6, 1e-5, 3)),
    ("epsilon_for", (1.1, 1e-5, 30, "rdp")),
    ("epsilon_for", (0.5, 1e-3, 1, "rdp")),
    ("epsilon_for", (6.0, 1e-5, 4, "classic")),
    ("epsilon_for", (1.0, 1e-5, 0, "rdp")),
    ("epsilon_for", (-1.0, 1e-5, 3, "rdp")),
    ("sigma_for", (8.0, 1e-5, 30, "rdp")),
    ("sigma_for", (2.0, 1e-5, 4, "classic")),
])
def test_accountants_match_reference(fn, args):
    got, want = getattr(port, fn)(*args), getattr(ref, fn)(*args)
    if math.isinf(want):
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_rdp_to_dp_matches_reference():
    curve = [port.gaussian_rdp(1.3, a, 5) for a in port.RDP_ORDERS]
    assert port.rdp_to_dp(curve, port.RDP_ORDERS, 1e-5) == pytest.approx(
        ref.rdp_to_dp(curve, ref.RDP_ORDERS, 1e-5), rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("fn,args", [
    ("gaussian_rdp", (1.0, 1.0)),                   # order <= 1
    ("subsampled_gaussian_rdp", (1.0, 0.3, 2.5)),   # non-integer order
    ("subsampled_gaussian_rdp", (1.0, 1.5, 3)),     # q outside [0, 1]
    ("epsilon_for", (1.0, 1e-5, 3, "moments")),     # unknown accountant
    ("epsilon_for", (1.0, 1e-5, 3, "classic")),     # per-release eps > 1
    ("epsilon_for", (1.0, 1.0, 3, "rdp")),          # delta >= 1
    ("epsilon_for", (1.0, 0.0, 3, "rdp")),          # delta <= 0
    ("amplified_epsilon_for", (1.0, 0.5, 2.0, 3)),
    ("rdp_to_dp", ([1.0], [2.0], -1e-5)),
    ("sigma_for", (0.0, 1e-5, 3, "rdp")),
    ("sigma_for", (30.0, 1e-5, 3, "classic")),
    ("sigma_for", (1.0, 1e-5, 3, "moments")),
])
def test_accountant_refusals_match_reference(fn, args):
    with pytest.raises(ValueError) as want:
        getattr(ref, fn)(*args)
    with pytest.raises(ValueError) as got:
        getattr(port, fn)(*args)
    assert str(got.value) == str(want.value)


def _tree(rng, slots=None):
    """A delta with a bias-free middle layer, some exact-zero gradient
    entries, and reveal masks that reveal some of those zeros."""
    lead = () if slots is None else (slots,)
    shapes = [{"w": (6, 5), "b": (5,)}, {"w": (5, 4), "b": None},
              {"w": (4, 1), "b": (1,)}]
    tree, masks = [], []
    for layer in shapes:
        t, m = {}, {}
        for k, shape in layer.items():
            if shape is None:
                t[k] = m[k] = None
                continue
            v = rng.standard_normal(lead + shape).astype(np.float32) * 0.3
            v[..., 0] = 0.0                     # exact zero gradients
            t[k] = v
            m[k] = rng.random(lead + shape) < 0.6
            m[k][..., 0] = True                 # ... some of them revealed
            t[k] = np.where(m[k] | (rng.random(lead + shape) < 0.5), t[k],
                            0.0).astype(np.float32)
        tree.append(t)
        masks.append(m)
    return tuple(tree), tuple(masks)


def _torch_tree(tree):
    return tuple({k: None if v is None else torch.from_numpy(np.array(v))
                  for k, v in layer.items()} for layer in tree)


@pytest.mark.parametrize("nm,clip", [(1.0, 1.0), (0.3, 0.05), (2.5, 10.0)])
def test_gaussian_mechanism_matches_reference(nm, clip):
    rng = np.random.default_rng(0)
    tree, masks = _tree(rng)
    key = jax.random.PRNGKey(3)
    want = ref.gaussian_mechanism(
        jax.tree_util.tree_map(jnp.asarray, tree), key, nm, clip,
        masks=jax.tree_util.tree_map(jnp.asarray, masks))
    noise = reference_normals(key, [v.shape for v in
                                    jax.tree_util.tree_leaves(tree)])
    got = port.gaussian_mechanism(_torch_tree(tree), noise, nm, clip,
                                  masks=_torch_tree(masks))
    for lg, lw in zip(np_tree(got), np_tree(want)):
        assert lg.keys() == lw.keys()
        for k in lw:
            if lw[k] is None:
                assert lg[k] is None
                continue
            np.testing.assert_allclose(lg[k], lw[k], rtol=1e-6, atol=1e-7)
    # noise lands on the revealed zero-gradient entries, nothing off-mask
    w0 = got[0]["w"].numpy()
    assert np.all(w0[:, 0] != 0)
    assert np.all(w0[~masks[0]["w"]] == 0)


def test_slot_stacked_mechanism_clips_each_slot_by_its_own_norm():
    """``slots=True``: S deltas at once, each clipped by its own global
    norm and noised with its own normals — slot s is the one-client call
    on slot s, and the reference's on it."""
    rng = np.random.default_rng(1)
    tree, masks = _tree(rng, slots=3)
    tree[0]["w"][1] *= 50.0                     # slot 1 is clipped hard
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    shapes = [v.shape[1:] for v in jax.tree_util.tree_leaves(tree)]
    per_slot = [reference_normals(k, shapes) for k in keys]
    noise = [np.stack([per_slot[s][j] for s in range(3)])
             for j in range(len(shapes))]
    got = port.gaussian_mechanism(_torch_tree(tree), noise, 0.8, 1.0,
                                  masks=_torch_tree(masks), slots=True)
    for s in range(3):
        one = tuple({k: None if v is None else v[s] for k, v in layer.items()}
                    for layer in tree)
        one_m = tuple({k: None if v is None else v[s]
                       for k, v in layer.items()} for layer in masks)
        want = ref.gaussian_mechanism(
            jax.tree_util.tree_map(jnp.asarray, one), keys[s], 0.8, 1.0,
            masks=jax.tree_util.tree_map(jnp.asarray, one_m))
        for lg, lw in zip(np_tree(got), np_tree(want)):
            for k in lw:
                if lw[k] is not None:
                    np.testing.assert_allclose(lg[k][s], lw[k], rtol=1e-6,
                                               atol=1e-7)


def test_clip_tree_matches_reference():
    tree, _ = _tree(np.random.default_rng(2))
    for bound in (1e-3, 1.0, 1e3):
        got, gnorm = port.clip_tree(_torch_tree(tree), bound)
        want, wnorm = ref.clip_tree(jax.tree_util.tree_map(jnp.asarray,
                                                           tree), bound)
        np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)
        for lg, lw in zip(np_tree(got), np_tree(want)):
            for k in lw:
                if lw[k] is not None:
                    np.testing.assert_allclose(lg[k], lw[k], rtol=1e-6,
                                               atol=1e-8)


@pytest.mark.parametrize("nm,clip,match", [
    (0.0, 1.0, "noise_multiplier"), (-1.0, 1.0, "noise_multiplier"),
    (1.0, 0.0, "max_norm"), (1.0, -2.0, "max_norm")])
def test_gaussian_mechanism_refusals_match_reference(nm, clip, match):
    tree, masks = _tree(np.random.default_rng(4))
    with pytest.raises(ValueError, match=match):
        ref.gaussian_mechanism(jax.tree_util.tree_map(jnp.asarray, tree),
                               jax.random.PRNGKey(0), nm, clip)
    with pytest.raises(ValueError, match=match):
        t = _torch_tree(tree)
        port.gaussian_mechanism(t, port.draw_normals(t, torch.Generator()),
                                nm, clip, masks=_torch_tree(masks))


def test_draw_normals_follows_the_generator_and_the_leaves():
    """``draw_normals`` gives one standard-normal tensor a leaf, in flatten
    order (``b`` before ``w``), the same for the same seed; the mechanism
    refuses noise that does not match the leaves."""
    tree, masks = _tree(np.random.default_rng(5))
    t = _torch_tree(tree)
    a, b = (port.draw_normals(t, torch.Generator().manual_seed(7))
            for _ in range(2))
    assert [tuple(z.shape) for z in a] == \
        [v.shape for v in jax.tree_util.tree_leaves(tree)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="noise"):
        port.gaussian_mechanism(t, a[:-1], 1.0, 1.0, masks=_torch_tree(masks))
    with pytest.raises(ValueError, match="shape"):
        port.gaussian_mechanism(t, a[::-1], 1.0, 1.0,
                                masks=_torch_tree(masks))


@pytest.mark.parametrize("method,scbf", [
    ("fedavg", dict(dp_noise_multiplier=1.0)),          # DP with fedavg
    ("scbf", dict(dp_noise_multiplier=-0.5)),           # negative
    ("scbf", dict(dp_noise_multiplier=1.0, dp_accountant="moments")),
    ("scbf", dict(dp_noise_multiplier=1.0, dp_accountant="classic")),
    ("scbf", dict(dp_noise_multiplier=8.0, dp_accountant="classic",
                  dp_amplification=True)),              # amplification
], ids=["fedavg", "negative", "unknown-accountant", "classic-eps-over-1",
        "amplification-without-rdp"])
def test_dp_gate_refuses_what_the_reference_refuses(method, scbf):
    feats = (16, 8, 4, 1)
    ref_cfg = RefTrainConfig(global_loops=1,
                             scbf=RefScbfConfig(num_clients=2, **scbf))
    port_cfg = tcfg.TrainConfig(global_loops=1,
                                scbf=tcfg.ScbfConfig(num_clients=2, **scbf))
    with pytest.raises(ValueError):
        ref_run(ref_cohort(num_admissions=200, num_medicines=16, seed=0),
                ref_cfg, method=method, mlp_features=feats)
    with pytest.raises(ValueError):
        run_federated(generate_cohort(num_admissions=200, num_medicines=16,
                                      seed=0),
                      port_cfg, method=method, mlp_features=feats,
                      device="cpu")
