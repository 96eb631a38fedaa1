"""The port's package-level surface against the reference's on the CPU:
the names ``repro.{comm,data,fed,kernels,metrics}`` export and their
counterparts in ``repro_torch``, the reference's jit-cache hooks given
their port meaning (0 where the port compiles nothing, the fused round
programs captured for ``fused_compile_count``; the resets clear them),
the module-level names ``core.selection``'s tree helpers,
``core.pruning.hidden_sizes`` and ``models.common.ax`` on small trees
against the reference's, the ``kernels`` wrappers against the
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
# the reference's jit-cache hooks, which ``repro.fed`` exports too
A15_HOOKS = {"reset_scbf_compile_count", "scbf_compile_count"}


def _public(mod) -> set:
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("package", PACKAGES)
def test_package_names_are_the_references(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    want = set(getattr(ref, "__all__", None) or _public(ref))
    assert set(port.__all__) == want
    for name in port.__all__:
        got = getattr(port, name)
        assert callable(got) and getattr(port, name) is got
        assert not inspect.getmodule(got).__name__.startswith("repro.")
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")
    if package == "fed":
        assert A15_HOOKS <= _public(ref) and A15_HOOKS <= set(port.__all__)


def test_from_imports_work():
    from repro_torch.comm import encode, tree_dense_bytes  # noqa: F401
    from repro_torch.data import SyntheticTokenStream  # noqa: F401
    from repro_torch.fed import make_engine, stack_pytrees  # noqa: F401
    from repro_torch.metrics import auc_roc  # noqa: F401
    from repro_torch.optim import linear_warmup_cosine  # noqa: F401


def _mlp(feats=(12, 6, 3, 1), seed=0):
    """A reference MLP tree and the port's copy of it."""
    ref = ref_init_mlp(feats, jax.random.PRNGKey(seed))
    return ref, from_numpy_tree(jax.tree_util.tree_map(np.asarray, ref),
                                "cpu")


def _same_tree(got, want):
    got = [(k, v.numpy()) for layer in got for k, v in sorted(layer.items())]
    want = [(k, np.asarray(v)) for layer in want
            for k, v in sorted(layer.items())]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_selection_tree_helpers_are_the_references():
    """``tree_sub``, ``tree_add``, ``tree_scale`` and ``tree_zeros_like``
    of two MLP trees: the reference's leaves, bitwise."""
    from repro.core import selection as ref_sel
    from repro_torch.core import selection as sel
    ra, pa = _mlp(seed=0)
    rb, pb = _mlp(seed=1)
    _same_tree(sel.tree_sub(pa, pb), ref_sel.tree_sub(ra, rb))
    _same_tree(sel.tree_add(pa, pb), ref_sel.tree_add(ra, rb))
    _same_tree(sel.tree_scale(pa, 0.37), ref_sel.tree_scale(ra, 0.37))
    _same_tree(sel.tree_zeros_like(pa), ref_sel.tree_zeros_like(ra))


def test_pruning_hidden_sizes_is_the_references():
    """A full and a compacted MLP tree: the same list of hidden widths."""
    from repro.core import pruning as ref_pruning
    from repro_torch.core import pruning
    ref, port = _mlp((40, 16, 8, 1))
    keep = [np.array([0, 2, 5, 7, 9]), np.arange(8)[::2]]
    for r, p in ((ref, port), (ref_pruning.apply_structure(ref, keep),
                               pruning.apply_structure(port, keep))):
        got = pruning.hidden_sizes(p)
        assert type(got) is list and got == ref_pruning.hidden_sizes(r)
    assert got == [5, 4]


def test_common_ax_is_the_references():
    """Axis names joined as the reference joins them, and split back."""
    from repro.models import common as ref_common
    from repro_torch.models import common
    for names in ((), ("embed",), ("embed", "mlp"), ("layers", "lora",
                                                     "heads")):
        assert common.ax(*names) == ref_common.ax(*names)
        assert common.split_ax(common.ax(*names)) == names


def test_compile_count_hooks(monkeypatch):
    """The reference's six jit-cache hooks in their port modules (and
    ``scbf_compile_count`` with its reset re-exported by ``fed``, as the
    reference's): the batched pass and the APoZ scorer compile nothing,
    0; ``fused_compile_count`` reads the round programs captured
    (``fed.graphs.captures``: none in a fused CPU run, which calls the
    round body itself; two when two programs were captured) and its reset
    sets it to 0, the replays' count untouched."""
    import repro.fed as ref_fed
    import repro_torch.fed as fed
    from repro_torch.config import FedConfig, ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import generate_cohort
    from repro_torch.fed import engine, graphs
    from repro_torch.kernels import apoz
    assert fed.scbf_compile_count is engine.scbf_compile_count
    assert fed.reset_scbf_compile_count is engine.reset_scbf_compile_count
    assert {"scbf_compile_count", "reset_scbf_compile_count"} <= \
        set(ref_fed.__all__ if hasattr(ref_fed, "__all__")
            else _public(ref_fed))
    engine.reset_fused_compile_count()
    res = run_federated(
        generate_cohort(num_admissions=800, num_medicines=40, seed=0),
        TrainConfig(learning_rate=0.05, global_loops=2, local_batch_size=64,
                    local_epochs=1, scbf=ScbfConfig(num_clients=3),
                    fed=FedConfig(fuse_rounds=2)),
        mlp_features=(40, 8, 1), device="cpu")
    assert len(res.records) == 2
    assert engine.fused_compile_count() == 0
    assert engine.scbf_compile_count() == 0
    assert apoz.apoz_scorer_compile_count() == 0
    monkeypatch.setattr(graphs, "captures", 2)
    monkeypatch.setattr(graphs, "replays", 7)
    assert engine.fused_compile_count() == 2
    engine.reset_fused_compile_count()
    assert engine.fused_compile_count() == 0 and graphs.replays == 7
    for reset in (engine.reset_scbf_compile_count,
                  apoz.reset_apoz_scorer_compile_count):
        assert reset() is None
    assert engine.scbf_compile_count() == 0
    assert apoz.apoz_scorer_compile_count() == 0


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


def test_launch_counts_name_every_kernel(monkeypatch):
    """``repro_torch.kernels.launch_counts`` reads the five kernels'
    counters (K1–K4 and ``sum_sgd``) by name, and ``reset_launches``
    clears every one of them."""
    import repro_torch.kernels as pk
    from repro_torch.kernels import apoz, channel_norm, select_mask, sum_sgd
    counters = [(channel_norm, "launches"), (select_mask, "mask_launches"),
                (select_mask, "compact_count_launches"),
                (select_mask, "compact_scatter_launches"),
                (apoz, "launches"), (sum_sgd, "launches")]
    for n, (mod, name) in enumerate(counters):
        monkeypatch.setattr(mod, name, n + 1)
    assert pk.launch_counts() == {
        "channel_norm": 1, "select_mask": 2, "select_compact_count": 3,
        "select_compact_scatter": 4, "apoz": 5, "sum_sgd": 6}
    pk.reset_launches()
    assert set(pk.launch_counts().values()) == {0}


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
