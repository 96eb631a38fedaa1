"""The port's entry-point substrate against the reference's: the
optimizers (``repro_torch.optim``) step for step, ``from_config``,
checkpoints (``repro_torch.checkpoint``) across the two packages, and
``run_fedavg``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.checkpoint.ckpt import load_checkpoint as ref_load
from repro.checkpoint.ckpt import save_checkpoint as ref_save
from repro.config import TrainConfig as RefTrainConfig
from repro.optim.sgd import apply_updates as ref_apply
from repro_torch import config as tcfg
from repro_torch import optim
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import run_fedavg, run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.optim import apply_updates, schedules

from _torch_parity import np_tree

OPTS = {"sgd": lambda m: m.sgd(0.1),
        "sgd-momentum": lambda m: m.sgd(0.1, momentum=0.9),
        "adam": lambda m: m.adam(0.05),
        "adamw": lambda m: m.adamw(0.05, weight_decay=0.01),
        "adam-cosine": lambda m: m.adam(m.cosine_decay(0.05, 20))}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return ({"w": rng.standard_normal((5, 3)).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32)},
            {"w": rng.standard_normal((3, 1)).astype(np.float32),
             "b": np.zeros(1, np.float32)})


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_reference_over_20_steps(name):
    """The same gradients 20 steps running: params and the state's moments
    allclose at rtol 1e-6, the step counter equal, moments fp32."""
    p_np = _params()
    rng = np.random.default_rng(1)
    grads = [tuple({k: rng.standard_normal(v.shape).astype(np.float32)
                    for k, v in layer.items()} for layer in p_np)
             for _ in range(20)]
    port, ref = OPTS[name](optim), OPTS[name](ref_optim)
    p = tuple({k: torch.from_numpy(v.copy()) for k, v in layer.items()}
              for layer in p_np)
    rp = tuple({k: jnp.asarray(v) for k, v in layer.items()}
               for layer in p_np)
    st, rst = port.init(p), ref.init(rp)
    for g in grads:
        upd, st = port.update(tuple({k: torch.from_numpy(v) for k, v in
                                     layer.items()} for layer in g), st, p)
        p = apply_updates(p, upd)
        rupd, rst = ref.update(tuple({k: jnp.asarray(v) for k, v in
                                      layer.items()} for layer in g),
                               rst, rp)
        rp = ref_apply(rp, rupd)
    for a, b in zip(np_tree(p), np_tree(rp)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7)
    assert int(st["step"]) == int(rst["step"]) == 20
    for key in set(st) - {"step"}:
        for a, b in zip(np_tree(st[key]), np_tree(rst[key])):
            for k in b:
                assert a[k].dtype == np.float32
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6,
                                           atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "sgd-momentum", "adam", "adamw"])
def test_optimizers_converge(name):
    opt = OPTS[name](optim)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    for _ in range(200):
        w = params["w"].clone().requires_grad_(True)
        g, = torch.autograd.grad(torch.sum((w - 3.0) ** 2), [w])
        upd, state = opt.update({"w": g}, state, params)
        params = apply_updates(params, upd)
    assert float(torch.sum((params["w"] - 3.0) ** 2)) < 1e-2


@pytest.mark.parametrize("kind", ["sgd", "adam", "adamw", "lbfgs"])
def test_from_config_matches_reference(kind):
    kw = dict(optimizer=kind, learning_rate=0.1, momentum=0.5,
              weight_decay=0.01)
    if kind == "lbfgs":
        with pytest.raises(ValueError, match="unknown optimizer"):
            optim.from_config(tcfg.TrainConfig(**kw))
        with pytest.raises(ValueError, match="unknown optimizer"):
            ref_optim.from_config(RefTrainConfig(**kw))
        return
    port = optim.from_config(tcfg.TrainConfig(**kw))
    ref = ref_optim.from_config(RefTrainConfig(**kw))
    p_np = _params(2)
    g_np = _params(3)
    upd, _ = port.update(tuple({k: torch.from_numpy(v) for k, v in
                                layer.items()} for layer in g_np),
                         port.init(tuple({k: torch.from_numpy(v) for k, v
                                          in layer.items()}
                                         for layer in p_np)),
                         tuple({k: torch.from_numpy(v) for k, v in
                                layer.items()} for layer in p_np))
    rupd, _ = ref.update(g_np, ref.init(p_np), p_np)
    for a, b in zip(np_tree(upd), np_tree(rupd)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)


def test_schedule_is_the_references():
    from repro.optim.schedules import cosine_decay as ref_cos
    steps = np.arange(0, 25)
    np.testing.assert_allclose(
        schedules.cosine_decay(0.05, 20)(torch.from_numpy(steps)).numpy(),
        np.asarray(ref_cos(0.05, 20)(jnp.asarray(steps))), rtol=1e-6)


def _tree_torch():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "d": [torch.zeros(2, dtype=torch.int32), torch.ones(1)],
            "e": None}


def _tree_jax():
    return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "b": {"c": jnp.ones((4,), jnp.bfloat16)},
            "d": [jnp.zeros((2,), jnp.int32), jnp.ones((1,))],
            "e": None}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree_torch()
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, tree, step=17)
    assert not os.path.exists(path + ".tmp.npz")
    restored, step = load_checkpoint(path, tree)
    assert step == 17
    assert restored["e"] is None
    for a, b in ((tree["a"], restored["a"]), (tree["b"]["c"],
                                              restored["b"]["c"]),
                 (tree["d"][0], restored["d"][0]),
                 (tree["d"][1], restored["d"][1])):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    """A checkpoint of either package loads in the other: the same keys,
    dtypes (bf16 restored from its fp32 file), values and step — the
    model's layer dicts as ``0/b``, ``0/w``, …"""
    path = os.path.join(tmp_path, "x.npz")
    model_np = _params(4)
    if direction == "port-to-reference":
        save_checkpoint(path, _tree_torch(), step=5)
        got, step = ref_load(path, _tree_jax())
        want = _tree_jax()
    else:
        ref_save(path, _tree_jax(), step=5)
        got, step = load_checkpoint(path, _tree_torch())
        want = _tree_torch()
    assert step == 5
    flat_got = jax.tree_util.tree_leaves(got) if direction.endswith(
        "reference") else [got["a"], got["b"]["c"], got["d"][0], got["d"][1]]
    flat_want = jax.tree_util.tree_leaves(want) if direction.endswith(
        "reference") else [want["a"], want["b"]["c"], want["d"][0],
                           want["d"][1]]
    for a, b in zip(flat_got, flat_want):
        assert str(a.dtype).split(".")[-1] == str(b.dtype).split(".")[-1]
        np.testing.assert_array_equal(
            np.asarray(a.float() if isinstance(a, torch.Tensor) else
                       np.asarray(a, np.float32)),
            np.asarray(b.float() if isinstance(b, torch.Tensor) else
                       np.asarray(b, np.float32)))
    model = tuple({k: torch.from_numpy(v) for k, v in layer.items()}
                  for layer in model_np)
    mpath = os.path.join(tmp_path, "model.npz")
    if direction == "port-to-reference":
        save_checkpoint(mpath, model, step=3)
        ref_model, _ = ref_load(mpath, tuple(
            {k: jnp.zeros(v.shape) for k, v in layer.items()}
            for layer in model_np))
        back = np_tree(ref_model)
    else:
        ref_save(mpath, model_np, step=3)
        back = np_tree(load_checkpoint(mpath, tuple(
            {k: torch.zeros(v.shape) for k, v in layer.items()}
            for layer in model_np))[0])
    assert sorted(np.load(mpath).files) == \
        ["0/b", "0/w", "1/b", "1/w", "__step__"]
    for a, b in zip(back, model_np):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_run_fedavg_is_run_federated_fedavg():
    cohort = generate_cohort(num_admissions=600, num_medicines=24, seed=0)
    cfg = tcfg.TrainConfig(learning_rate=0.05, global_loops=2,
                           local_batch_size=32,
                           scbf=tcfg.ScbfConfig(num_clients=3))
    a = run_fedavg(cohort, cfg, mlp_features=(24, 8, 4, 1), device="cpu")
    b = run_federated(cohort, cfg, method="fedavg",
                      mlp_features=(24, 8, 4, 1), device="cpu")
    assert a.method == b.method == "fedavg"
    assert [(r.auc_roc, r.sparse_bytes) for r in a.records] == \
        [(r.auc_roc, r.sparse_bytes) for r in b.records]
    assert all(torch.equal(x[k], y[k]) for x, y in
               zip(a.final_params, b.final_params) for k in x)
