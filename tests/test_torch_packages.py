"""The port's package-level surface against the reference's on the CPU:
the names ``repro.{comm,data,fed,kernels,metrics}`` export and their
counterparts in ``repro_torch`` (the reference's jit-cache hooks the
only names left out: ROADMAP A15), the ``kernels`` wrappers against the
reference's ``ops`` (K1 within 1e-6, K2 and K4 exact), ``tree_dense_bytes``
exact, ``linear_warmup_cosine`` within 1e-7, and
``benchmarks/torch_table_communication.py`` with the reference's draws
injected: fractions, bytes and codec mix exactly the reference's."""
import importlib
import importlib.util
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as ref_wire
from repro.models.mlp_net import init_mlp as ref_init_mlp
from repro_torch.comm import wire as port_wire
from repro_torch.params import from_numpy_tree

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ["comm", "data", "fed", "kernels", "metrics"]
# the reference's jit-cache hooks: no counterpart (ROADMAP A15)
A15_HOOKS = {"reset_scbf_compile_count", "scbf_compile_count"}


def _public(mod) -> set:
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("package", PACKAGES)
def test_package_names_are_the_references(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    want = set(getattr(ref, "__all__", None) or _public(ref)) - A15_HOOKS
    assert set(port.__all__) == want
    for name in port.__all__:
        got = getattr(port, name)
        assert callable(got) and getattr(port, name) is got
        assert not inspect.getmodule(got).__name__.startswith("repro.")
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")
    if package == "fed":
        assert A15_HOOKS <= _public(ref)


def test_from_imports_work():
    from repro_torch.comm import encode, tree_dense_bytes  # noqa: F401
    from repro_torch.data import SyntheticTokenStream  # noqa: F401
    from repro_torch.fed import make_engine, stack_pytrees  # noqa: F401
    from repro_torch.metrics import auc_roc  # noqa: F401
    from repro_torch.optim import linear_warmup_cosine  # noqa: F401


def test_kernel_wrappers_are_the_references_ops():
    """``repro_torch.kernels``' names on CPU tensors (the plain versions)
    against ``repro.kernels``' ``ops``, and no library built or loaded by
    importing and resolving them."""
    import repro.kernels as rk
    import repro_torch.kernels as pk
    from repro_torch.kernels import build

    rng = np.random.default_rng(0)
    g = rng.normal(size=(33, 20)).astype(np.float32)
    g[3] = 0.0
    rr, rc = rk.channel_norms(jnp.asarray(g))
    pr, pc = pk.channel_norms(torch.from_numpy(g))
    np.testing.assert_allclose(pr.numpy(), np.asarray(rr), rtol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=1e-6)
    thr = float(np.median(np.asarray(rr)) + np.median(np.asarray(rc)))
    args = (torch.from_numpy(np.array(rr)), torch.from_numpy(np.array(rc)),
            thr)
    want = rk.select_mask(jnp.asarray(g), rr, rc, thr)
    got, mask, count = pk.select_mask(torch.from_numpy(g), *args)
    assert np.array_equal(got.numpy(), np.asarray(want))
    wf, wc = rk.scbf_select_fused(jnp.asarray(g), rr, rc, thr)
    gf, gc = pk.scbf_select_fused(torch.from_numpy(g), *args)
    assert np.array_equal(gf.numpy(), np.asarray(wf))
    assert int(gc) == int(wc) == int(count) == int(mask.sum())
    acts = np.maximum(rng.normal(size=(64, 24)), 0).astype(np.float32)
    assert np.array_equal(pk.apoz_counts(torch.from_numpy(acts)).numpy(),
                          np.asarray(rk.apoz_counts(jnp.asarray(acts))))
    assert build.libraries.cache_info().currsize == 0


def test_tree_dense_bytes():
    """An MLP tree and a tree of bf16 and fp32 leaves with an absent bias:
    the reference's bytes."""
    mlp = ref_init_mlp((40, 16, 1), jax.random.PRNGKey(0))
    lm = {"embed": {"w": jnp.zeros((12, 8), jnp.bfloat16)},
          "router": {"w": jnp.zeros((8, 4), jnp.float32), "b": None},
          "stack": [jnp.ones((3, 5), jnp.bfloat16)]}
    for tree in (mlp, lm):
        port = from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree),
                               "cpu")
        assert port_wire.tree_dense_bytes(port) == \
            ref_wire.tree_dense_bytes(tree)
    assert port_wire.tree_dense_bytes(from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, lm), "cpu")) == \
        12 * 8 * 2 + 8 * 4 * 4 + 3 * 5 * 2


@pytest.mark.parametrize("lr,warmup,decay,alpha", [
    (0.1, 10, 100, 0.0), (3e-4, 7, 50, 0.1), (1.0, 0, 20, 0.0),
    (0.5, 30, 30, 0.05), (0.2, 40, 25, 0.0)])
def test_linear_warmup_cosine(lr, warmup, decay, alpha):
    """Steps 0 … 2·decay, as int32 arrays and as Python ints; the
    reference's ``max(·, 1)`` guards (no warm-up; decay ≤ warm-up)."""
    from repro.optim import schedules as ref_s
    from repro_torch.optim import linear_warmup_cosine

    want_fn = ref_s.linear_warmup_cosine(lr, warmup, decay, alpha)
    got_fn = linear_warmup_cosine(lr, warmup, decay, alpha)
    steps = np.arange(2 * decay + 1, dtype=np.int32)
    want = np.asarray(want_fn(jnp.asarray(steps)))
    got = got_fn(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7)
    for s in (0, warmup, decay, 2 * decay):
        assert float(got_fn(s)) == pytest.approx(
            float(want_fn(jnp.asarray(s, jnp.int32))), rel=1e-7, abs=1e-7)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_grads(feats, seed):
    """The reference script's gradient draws: ``normal(fold_in(key,
    size)) * 0.01`` a leaf."""
    key = jax.random.PRNGKey(seed)
    params = ref_init_mlp(feats, key)
    grads = jax.tree_util.tree_map(
        lambda p: jax.random.normal(jax.random.fold_in(key, p.size),
                                    p.shape) * 0.01, params)
    return tuple({k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
                 for layer in grads)


def test_communication_table_is_the_references():
    """The quick setting's six rows (positive at 0.05 … 0.90, negative at
    0.10) with the reference's draws injected: the same fraction, encoded
    and dense bytes and codec mix; and the port's own draws give rows of
    the same form."""
    ref = _load("table_communication")
    port = _load("torch_table_communication")
    feats = port.QUICK
    rows = [("positive", r) for r in port.RATES] + [("negative", 0.10)]
    want_rows = ref.run(quick=True)
    assert [(m, r) for m, r, *_ in want_rows] == rows
    for (mode, rate), want in zip(rows, want_rows):
        got = port.measure_upload(rate, feats, mode, device="cpu",
                                  grads=_reference_grads(feats, 0))
        assert got[0] == want[2] and got[1:3] == want[3:5]
        assert dict(got[3]) == dict(want[5])
    own = port.main(["--device", "cpu"])
    assert len(own) == 6 and all(0 < r[2] <= 1 and r[3] <= r[4]
                                 for r in own)
    assert port.csv_lines(want_rows) == [
        "selection,rate,param_fraction_uploaded,encoded_bytes,dense_bytes,"
        "saving,codecs"] + [
        f"{m},{r},{f:.4f},{e},{d},{1.0 - e / max(d, 1):.2%},"
        + "+".join(f"{v}x{k}" for k, v in sorted(c.items()))
        for m, r, f, e, d, c in want_rows]
