"""The port's model, metrics, schedules and cohort against the reference
on the CPU, from the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as RefTrainConfig
from repro.core import scbf as ref_scbf
from repro.data import medical as ref_medical
from repro.metrics import auc as ref_auc
from repro.models import mlp_net as ref_mlp
from repro.optim import schedules as ref_sched
from repro_torch import config as tcfg
from repro_torch.core import scbf as port_scbf
from repro_torch.data import medical as port_medical
from repro_torch.metrics import auc as port_auc
from repro_torch.models import mlp_net as port_mlp
from repro_torch.optim import schedules as port_sched
from repro_torch.params import from_numpy, to_numpy

from _torch_parity import np_tree

FEATS = (40, 24, 12, 1)


def _ref_params(seed=0):
    return np_tree(ref_mlp.init_mlp(FEATS, jax.random.PRNGKey(seed)))


def test_params_round_trip_numpy_torch():
    p = _ref_params()
    back = to_numpy(from_numpy(p, "cpu"))
    for a, b in zip(p, back):
        for k in a:
            assert np.array_equal(a[k], b[k])


@pytest.mark.parametrize("masked", [False, True])
def test_mlp_forward_and_activations_match(masked):
    p = _ref_params()
    x = (np.random.default_rng(0).random((50, FEATS[0])) < 0.2) \
        .astype(np.float32)
    nm = [np.random.default_rng(1).integers(0, 2, f).astype(np.float32)
          for f in FEATS[1:-1]] if masked else None
    want = ref_mlp.mlp_forward(p, jnp.asarray(x),
                               None if nm is None else
                               [jnp.asarray(m) for m in nm])
    tp = from_numpy(p, "cpu")
    tnm = None if nm is None else [torch.from_numpy(m) for m in nm]
    got = port_mlp.mlp_forward(tp, torch.from_numpy(x), tnm)
    assert got.shape == (50,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    wa = ref_mlp.mlp_activations(p, jnp.asarray(x),
                                 None if nm is None else
                                 [jnp.asarray(m) for m in nm])
    ga = port_mlp.mlp_activations(tp, torch.from_numpy(x), tnm)
    assert len(ga) == len(wa) == 2
    for g, w in zip(ga, wa):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_slot_stacked_forward_is_per_slot_forward():
    """Slot-stacked params (w (S, in, out), b (S, out)) and inputs
    (S, B, in): slot s is the one-client forward on slot s, neuron masks
    shared."""
    p = from_numpy(_ref_params(), "cpu")
    rng = np.random.default_rng(5)
    stacked = tuple({k: torch.stack([v * (1 + 0.1 * s) for s in range(3)])
                     for k, v in layer.items()} for layer in p)
    x = torch.from_numpy((rng.random((3, 20, FEATS[0])) < 0.3)
                         .astype(np.float32))
    nm = [torch.from_numpy(rng.integers(0, 2, f).astype(np.float32))
          for f in FEATS[1:-1]]
    got = port_mlp.mlp_forward(stacked, x, nm)
    acts = port_mlp.mlp_activations(stacked, x, nm)
    assert got.shape == (3, 20)
    for s in range(3):
        one = tuple({k: v[s] for k, v in layer.items()} for layer in stacked)
        np.testing.assert_allclose(got[s].numpy(),
                                   port_mlp.mlp_forward(one, x[s], nm).numpy(),
                                   rtol=1e-6, atol=1e-6)
        for a, b in zip(acts, port_mlp.mlp_activations(one, x[s], nm)):
            np.testing.assert_allclose(a[s].numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_bce_gradient_at_a_zero_logit_is_the_references():
    """At a logit of exactly 0 (an all-zero example through zero biases)
    the loss's slope is the reference's subgradient, -y: JAX splits the
    tie of max(x, 0) in halves and gives |x| slope 1 at 0."""
    logits = np.array([0.0, 0.0, 0.0, 1.5, -2.0], np.float32)
    labels = np.array([0.0, 1.0, 1.0, 0.0, 1.0], np.float32)
    want = jax.grad(lambda z: jnp.sum(ref_auc.bce_elementwise(
        z, jnp.asarray(labels))))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    torch.sum(port_auc.bce_elementwise(z, torch.from_numpy(labels))
              ).backward()
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(z.grad.numpy()[:3], -labels[:3])


def test_init_mlp_shapes_and_scale():
    p = port_mlp.init_mlp((300, 64, 1), torch.Generator().manual_seed(0))
    assert [tuple(l["w"].shape) for l in p] == [(300, 64), (64, 1)]
    assert all(torch.count_nonzero(l["b"]) == 0 for l in p)
    np.testing.assert_allclose(float(p[0]["w"].std()), np.sqrt(2 / 300),
                               rtol=0.05)
    assert port_mlp.hidden_sizes(p) == (64,)


@pytest.mark.parametrize("ties", [False, True])
def test_auc_matches_reference(ties):
    rng = np.random.default_rng(3)
    y = (rng.random(500) < 0.4).astype(np.float32)
    s = (rng.standard_normal(500) + 1.5 * y).astype(np.float32)
    if ties:
        s = np.round(s * 4) / 4        # many tied blocks
    for ref_fn, port_fn in ((ref_auc.auc_roc, port_auc.auc_roc),
                            (ref_auc.auc_pr, port_auc.auc_pr)):
        want = float(ref_fn(jnp.asarray(s), jnp.asarray(y)))
        got = float(port_fn(torch.from_numpy(s), torch.from_numpy(y)))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_bce_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal(200) * 30).astype(np.float32)
    labels = (rng.random(200) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        port_auc.bce_elementwise(torch.from_numpy(logits),
                                 torch.from_numpy(labels)).numpy(),
        np.asarray(ref_auc.bce_elementwise(jnp.asarray(logits),
                                           jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(port_auc.binary_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(labels))),
        float(ref_auc.binary_cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(labels))),
        rtol=1e-6)


def test_schedules_and_lr_table_match_reference():
    steps = np.arange(12)
    want = jax.vmap(ref_sched.cosine_decay(0.05, 9, alpha=0.1))(
        jnp.asarray(steps))
    got = port_sched.cosine_decay(0.05, 9, alpha=0.1)(torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for sched in ("constant", "cosine"):
        ref_t = ref_scbf._lr_table(RefTrainConfig(
            learning_rate=0.03, global_loops=7, lr_schedule=sched))
        port_t = port_scbf._lr_table(tcfg.TrainConfig(
            learning_rate=0.03, global_loops=7, lr_schedule=sched))
        assert port_t.dtype == ref_t.dtype == np.float32
        np.testing.assert_allclose(port_t, ref_t, rtol=1e-6)


def test_cohort_and_splits_are_byte_identical():
    kw = dict(num_admissions=900, num_medicines=50, seed=5)
    ref, port = ref_medical.generate_cohort(**kw), \
        port_medical.generate_cohort(**kw)
    for name in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for split, kw2 in ((ref_medical.federated_split, {}),
                       (ref_medical.dirichlet_split, {"alpha": 0.3})):
        port_split = getattr(port_medical, split.__name__)
        for (xa, ya), (xb, yb) in zip(
                split(ref.x_train, ref.y_train, 4, seed=5, **kw2),
                port_split(port.x_train, port.y_train, 4, seed=5, **kw2)):
            assert xa.tobytes() == xb.tobytes() and \
                ya.tobytes() == yb.tobytes()
