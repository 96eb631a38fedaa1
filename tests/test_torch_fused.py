"""The port's fused round loop (``FedConfig.fuse_rounds`` > 1) on the CPU.

The fused run against the port's own per-round run, bitwise (params,
bytes, upload fractions, ε, hidden sizes): SCBF at full participation,
with DP (injected and drawn normals), with varying bucketed P under
sampling and dropout, on the sampled quantile path, and mask-mode SCBFwP
with and without DP; FedAvg to allclose, as the reference promises.  The
fused run against the reference's fused run with the reference's draws
injected.  The fallbacks (sequential engine, reshape pruning), the
``engine=`` keyword, and the pieces — ``horizon_slot_plan``,
``fused_chunk_len``, ``plan_horizon`` and the stacked reducers — against
the reference's.  These mirror ``tests/test_fused_rounds.py`` and
``tests/test_fused_pruning.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as RefFedConfig
from repro.config import ScbfConfig as RefScbfConfig
from repro.config import TrainConfig as RefTrainConfig
from repro.core.scbf import run_federated as ref_run
from repro.data.medical import federated_split as ref_split
from repro.data.medical import generate_cohort as ref_cohort
from repro.fed import cohort as ref_cohort_mod
from repro.fed import strategy as ref_strategy
from repro.fed.scheduler import make_scheduler as ref_make_scheduler
from repro_torch import config as tcfg
from repro_torch.comm import wire
from repro_torch.core import channels
from repro_torch.core.client import local_train_slots
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.fed import cohort, engine, graphs, scheduler, strategy
from repro_torch.params import from_numpy

from _torch_parity import np_tree, reference_draws

FEATS = (40, 16, 4, 1)
COHORT = dict(num_admissions=800, num_medicines=40, num_risk_medicines=15,
              num_interactions=4, seed=0)
PRUNE = dict(prune=True, prune_rate=0.2, prune_total=0.5, prune_impl="mask")
DP = dict(dp_noise_multiplier=1.0, dp_clip_norm=1.0)


@pytest.fixture(scope="module")
def port_cohort():
    return generate_cohort(**COHORT)


def _cfg(fuse, loops=4, K=5, batch=64, eval_every=1, scbf=None, **fed):
    return tcfg.TrainConfig(
        learning_rate=0.05, global_loops=loops, local_batch_size=batch,
        local_epochs=1, eval_every=eval_every,
        scbf=tcfg.ScbfConfig(upload_rate=0.1, num_clients=K, **(scbf or {})),
        fed=tcfg.FedConfig(fuse_rounds=fuse, **fed))


def _normals(loop, i, shapes):
    r = np.random.default_rng(1000 * loop + i)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def _bitwise(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def _same_records(per_round, fused):
    assert len(per_round.records) == len(fused.records)
    for a, b in zip(per_round.records, fused.records):
        assert (a.loop, a.num_participants, a.sparse_bytes, a.dense_bytes,
                a.upload_fraction, a.epsilon, a.hidden_sizes,
                a.flops_proxy) == \
            (b.loop, b.num_participants, b.sparse_bytes, b.dense_bytes,
             b.upload_fraction, b.epsilon, b.hidden_sizes, b.flops_proxy)
        assert not a.wall_is_amortized and b.wall_is_amortized


@pytest.mark.parametrize("case,fuse,kw,dp_noise", [
    ("scbf", 3, dict(loops=5), False),
    ("dp-injected", 4, dict(scbf=DP), True),
    ("dp-drawn", 3, dict(loops=5, scbf=DP), False),
    ("varying-p", 3, dict(loops=7, K=8, batch=32, sample_fraction=0.5,
                          dropout_rate=0.25), False),
    ("mask", 4, dict(loops=8, scbf=PRUNE), False),
    ("mask-dp", 3, dict(loops=6, scbf=dict(PRUNE, **DP)), True),
    ("mask-uncompacted", 3, dict(loops=8, scbf=dict(PRUNE,
                                                    prune_compact=False)),
     False),
])
def test_fused_matches_per_round_bitwise(port_cohort, case, fuse, kw,
                                         dp_noise):
    """fuse_rounds=S is the per-round run bitwise: the same participation,
    bytes, upload fractions, ε, hidden sizes and final params — and it ran
    fused (amortised walls; evaluation at chunk boundaries, so loops
    inside a chunk of full length are not evaluated)."""
    extra = dict(dp_noise=_normals) if dp_noise else {}
    a = run_federated(port_cohort, _cfg(1, **kw), mlp_features=FEATS,
                      device="cpu", **extra)
    b = run_federated(port_cohort, _cfg(fuse, **kw), mlp_features=FEATS,
                      device="cpu", **extra)
    _same_records(a, b)
    assert _bitwise(a.final_params, b.final_params)
    assert sum(r.sparse_bytes for r in a.records) > 0
    assert all(r.evaluated for r in a.records)
    assert not all(r.evaluated for r in b.records) and b.final.evaluated
    if "dp" in case:
        assert all(r.epsilon is not None for r in b.records)
    if case == "varying-p":
        assert len({r.num_participants for r in a.records
                    if r.num_participants}) > 1
    if case.startswith("mask"):
        assert a.records[0].hidden_sizes != a.records[-1].hidden_sizes
        full = tuple(layer["w"].shape[1] for layer in b.final_params[:-1])
        want = FEATS[1:-1] if case == "mask-uncompacted" \
            else b.final.hidden_sizes
        assert full == tuple(want)


def test_fused_sampled_quantile_path_matches_per_round(port_cohort,
                                                       monkeypatch):
    """Past MAX_MATERIALIZED channels the threshold samples channels on the
    run's generator: the fused run draws a chunk's indices before it, in
    the per-round order (after each round's permutations, for the round's
    bucket of slots), so the two runs stay bitwise equal — with varying P
    and with mask-mode pruning (indices among the kept neurons)."""
    monkeypatch.setattr(channels, "MAX_MATERIALIZED", 16)
    for kw in (dict(loops=5, K=8, batch=32, sample_fraction=0.5,
                    dropout_rate=0.25),
               dict(loops=6, scbf=PRUNE)):
        a = run_federated(port_cohort, _cfg(1, **kw), mlp_features=FEATS,
                          device="cpu")
        b = run_federated(port_cohort, _cfg(3, **kw), mlp_features=FEATS,
                          device="cpu")
        _same_records(a, b)
        assert _bitwise(a.final_params, b.final_params)


def test_fused_fedavg_matches_per_round(port_cohort):
    """Fused FedAvg averages on the device (``fedavg_step``); the
    reference promises allclose here (XLA contracts the multiply-add)."""
    a = run_federated(port_cohort, _cfg(1, loops=5), method="fedavg",
                      mlp_features=FEATS, device="cpu")
    b = run_federated(port_cohort, _cfg(3, loops=5), method="fedavg",
                      mlp_features=FEATS, device="cpu")
    for x, y in zip(a.final_params, b.final_params):
        for k in x:
            np.testing.assert_allclose(x[k].numpy(), y[k].numpy(),
                                       atol=1e-6, rtol=1e-5)
    assert a.final.auc_roc == pytest.approx(b.final.auc_roc, abs=1e-6)
    assert [r.dense_bytes for r in a.records] == \
        [r.dense_bytes for r in b.records]


def test_fused_evaluates_at_chunk_boundaries(port_cohort):
    """Evaluation coarsens to chunk boundaries; the final loop is always
    evaluated, and the other loops carry the last-known metrics."""
    res = run_federated(port_cohort, _cfg(3, loops=6), mlp_features=FEATS,
                        device="cpu")
    assert [r.evaluated for r in res.records] == \
        [False, False, True, False, False, True]
    for i in (0, 1):
        assert res.records[i].auc_roc == res.records[0].auc_roc
    for i in (3, 4):
        assert res.records[i].auc_roc == res.records[2].auc_roc
    walls = [r.wall_time for r in res.records]
    assert walls[0] == walls[1] == walls[2] and walls[3] == walls[4]


@pytest.mark.parametrize("case,scbf,loops,fuse", [
    ("scbf", {}, 4, 2),
    ("scbf-dp", DP, 4, 3),
    ("scbfwp-mask", dict(PRUNE, prune_rate=0.25, prune_total=0.4), 5, 2),
])
def test_fused_run_matches_reference_fused_run(case, scbf, loops, fuse):
    """The port's fused run against the reference's (``fuse_rounds=S``),
    the reference's initial weights, permutations and DP normals
    injected: per loop the same bytes, upload fractions, hidden sizes, ε,
    ``evaluated`` and ``wall_is_amortized``, and AUC to 1e-3; the final
    weights to 1e-5."""
    feats, k, epochs, batch, seed = (64, 32, 16, 1), 3, 1, 64, 0
    ref_c = ref_cohort(num_admissions=1500, num_medicines=64, seed=seed)
    shards = ref_split(ref_c.x_train, ref_c.y_train, k, seed=seed)
    n_max = max(len(y) for _, y in shards)
    init, perms, dp_noise = reference_draws(seed, feats, [n_max] * k, loops,
                                            epochs)
    lr = 0.05 / k
    want = ref_run(ref_c, RefTrainConfig(
        learning_rate=lr, global_loops=loops, local_epochs=epochs,
        local_batch_size=batch, seed=seed,
        scbf=RefScbfConfig(num_clients=k, **scbf),
        fed=RefFedConfig(fuse_rounds=fuse)), method="scbf",
        mlp_features=feats)
    got = run_federated(
        generate_cohort(num_admissions=1500, num_medicines=64, seed=seed),
        tcfg.TrainConfig(learning_rate=lr, global_loops=loops,
                         local_epochs=epochs, local_batch_size=batch,
                         seed=seed, scbf=tcfg.ScbfConfig(num_clients=k,
                                                         **scbf),
                         fed=tcfg.FedConfig(fuse_rounds=fuse)),
        method="scbf", mlp_features=feats, device="cpu", init_params=init,
        perms=perms, dp_noise=dp_noise)
    assert len(got.records) == len(want.records) == loops
    for g, w in zip(got.records, want.records):
        assert (g.sparse_bytes, g.dense_bytes, g.upload_fraction,
                g.hidden_sizes, g.epsilon, g.evaluated,
                g.wall_is_amortized, g.num_participants) == \
            (w.sparse_bytes, w.dense_bytes, w.upload_fraction,
             tuple(w.hidden_sizes), w.epsilon, w.evaluated,
             w.wall_is_amortized, w.num_participants)
        np.testing.assert_allclose(g.auc_roc, w.auc_roc, atol=1e-3)
        np.testing.assert_allclose(g.auc_pr, w.auc_pr, atol=1e-3)
    assert not all(r.evaluated for r in got.records)
    for lg, lw in zip(np_tree(got.final_params), np_tree(want.final_params)):
        for k in lw:
            assert lg[k].shape == lw[k].shape
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case,kw", [
    ("sequential", dict(engine="sequential")),
    ("reshape", dict(scbf=dict(PRUNE, prune_impl="reshape"), loops=5)),
])
def test_fused_falls_back_to_per_round(port_cohort, case, kw):
    """Where the reference falls back — the sequential engine and reshape
    pruning (FAwP's route too) — the port runs per round without raising:
    every loop evaluated, no amortised wall, the per-round trajectory."""
    loops = kw.pop("loops", 4)
    a = run_federated(port_cohort, _cfg(1, loops=loops, **kw),
                      mlp_features=FEATS, device="cpu")
    b = run_federated(port_cohort, _cfg(3, loops=loops, **kw),
                      mlp_features=FEATS, device="cpu")
    assert all(r.evaluated and not r.wall_is_amortized for r in b.records)
    assert [(r.sparse_bytes, r.hidden_sizes) for r in a.records] == \
        [(r.sparse_bytes, r.hidden_sizes) for r in b.records]
    assert _bitwise(a.final_params, b.final_params)


def test_engine_keyword_overrides_the_config(port_cohort):
    """``run_federated(..., engine=...)`` overrides ``fed.engine``, as the
    reference's keyword does (``repro/core/scbf.py``)."""
    seq = run_federated(port_cohort, _cfg(1, loops=2, engine="sequential"),
                        mlp_features=FEATS, device="cpu")
    kw = run_federated(port_cohort, _cfg(1, loops=2), mlp_features=FEATS,
                       device="cpu", engine="sequential")
    assert _bitwise(seq.final_params, kw.final_params)
    assert [r.sparse_bytes for r in seq.records] == \
        [r.sparse_bytes for r in kw.records]
    # and a fused config on the sequential engine falls back
    fused = run_federated(port_cohort, _cfg(2, loops=2), mlp_features=FEATS,
                          device="cpu", engine="sequential")
    assert _bitwise(seq.final_params, fused.final_params)
    ref = ref_run(ref_cohort(**COHORT), RefTrainConfig(
        learning_rate=0.05, global_loops=1, local_batch_size=64,
        scbf=RefScbfConfig(upload_rate=0.1, num_clients=5)),
        mlp_features=FEATS, engine="sequential")
    assert len(ref.records) == 1


@pytest.mark.parametrize("parts,slots,horizon", [
    ([[0, 1, 2, 3, 4]], 5, 1),
    ([[0, 2, 4], [1], []], 4, 4),
    ([[3, 5], [0, 1, 2, 7], [6]], 4, 3),
])
def test_horizon_slot_plan_matches_reference(parts, slots, horizon):
    parts = [np.asarray(p, np.int64) for p in parts]
    got = cohort.horizon_slot_plan(parts, slots, horizon)
    want = ref_cohort_mod.horizon_slot_plan(parts, slots, horizon)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_horizon_slot_plan_and_chunk_len_refusals_match_reference():
    for args in (([np.arange(2)] * 3, 4, 2), ([np.arange(5)], 4, 1)):
        with pytest.raises(ValueError):
            ref_cohort_mod.horizon_slot_plan(*args)
        with pytest.raises(ValueError):
            cohort.horizon_slot_plan(*args)
    for left in range(1, 7):
        for fuse in (1, 2, 4):
            for active in (False, True):
                assert cohort.fused_chunk_len(left, fuse, active) == \
                    ref_cohort_mod.fused_chunk_len(left, fuse, active)
    with pytest.raises(ValueError):
        ref_cohort_mod.fused_chunk_len(0, 2, False)
    with pytest.raises(ValueError):
        cohort.fused_chunk_len(0, 2, False)


def test_plan_horizon_matches_reference_and_per_round_plans():
    """``plan_horizon`` draws what ``plan`` called a round at a time
    draws, and the reference's trace, round for round."""
    kw = dict(sample_fraction=0.5, dropout_rate=0.2)
    mine = scheduler.SyncScheduler(16, tcfg.FedConfig(**kw), seed=3)
    single = scheduler.SyncScheduler(16, tcfg.FedConfig(**kw), seed=3)
    ref = ref_make_scheduler(RefFedConfig(**kw), 16, seed=3)
    horizon = mine.plan_horizon(0, 6)
    for i, (a, w) in enumerate(zip(horizon, ref.plan_horizon(0, 6))):
        b = single.plan(i)
        for f in ("participants", "sampled", "dropped", "stragglers"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(getattr(a, f), getattr(w, f))
        assert a.round_index == w.round_index == i
    assert mine.max_participants == ref.max_participants == 8
    with pytest.raises(ValueError):
        mine.plan_horizon(0, 0)


def _stack(seed, b, feats=(12, 6, 3, 1), zero_slots=()):
    rng = np.random.default_rng(seed)
    out = []
    for a, c in zip(feats[:-1], feats[1:]):
        w = rng.standard_normal((b, a, c)).astype(np.float32) * 0.1
        bias = rng.standard_normal((b, c)).astype(np.float32) * 0.1
        w[list(zero_slots)] = 0.0
        bias[list(zero_slots)] = 0.0
        out.append({"b": bias, "w": w})
    return tuple(out)


@pytest.mark.parametrize("masked", [False, True])
def test_scbf_sum_step_matches_reference_and_apply_payloads(masked):
    """``scbf_sum_step`` is the reference's bitwise (delta-first in slot
    order, one add into W), and bitwise ``wire.apply_payloads`` of the
    slots' encoded uploads; with keep-masks the pruned coordinates of W
    stay frozen (``_mask_total``)."""
    params = np_tree(_stack(0, 1))
    params = tuple({k: v[0] for k, v in layer.items()} for layer in params)
    deltas = _stack(1, 4, zero_slots=(3,))
    nm = None
    if masked:
        nm = [np.ones(6, np.float32), np.ones(3, np.float32)]
        nm[0][[1, 4]] = 0.0
        nm[1][2] = 0.0
        for l, layer in enumerate(deltas):       # pruned coords: exact 0
            if l < 2:
                layer["w"][..., nm[l] == 0] = 0.0
                layer["b"][..., nm[l] == 0] = 0.0
            if l > 0:
                layer["w"][:, nm[l - 1] == 0, :] = 0.0
    t = lambda tree: from_numpy(tree, "cpu")
    got = strategy.scbf_sum_step(
        t(params), tuple({k: torch.from_numpy(v) for k, v in layer.items()}
                         for layer in deltas),
        None if nm is None else [torch.from_numpy(m) for m in nm])
    want = ref_strategy.scbf_sum_step(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, deltas),
        None if nm is None else [jnp.asarray(m) for m in nm])
    for g, w in zip(np_tree(got), np_tree(want)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    payloads = [wire.encode(tuple({k: v[s] for k, v in layer.items()}
                                  for layer in deltas)) for s in range(3)]
    applied = wire.apply_payloads(t(params), payloads)
    assert _bitwise(got, applied)
    if masked:
        total = tuple({k: v[0] for k, v in layer.items()}
                      for layer in _stack(2, 1))
        totals = ref_strategy._mask_total(
            jax.tree_util.tree_map(jnp.asarray, total),
            [jnp.asarray(m) for m in nm])
        mine = strategy._mask_total(from_numpy(total, "cpu"),
                                    [torch.from_numpy(m) for m in nm])
        for g, w in zip(np_tree(mine), np_tree(totals)):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_fedavg_step_matches_reference():
    """``fedavg_step`` against the reference's to 1e-6 (XLA may contract
    the multiply-add), bitwise ``core.server.fedavg_update`` of the valid
    slots, and an all-zero-weight round leaves W bitwise unchanged."""
    from repro_torch.core import server
    params = tuple({k: v[0] for k, v in layer.items()}
                   for layer in np_tree(_stack(0, 1)))
    stack = _stack(5, 4)
    n = np.array([30.0, 50.0, 20.0])
    wts = np.zeros(4, np.float32)
    wts[:3] = (n / n.sum()).astype(np.float32)
    torch_stack = tuple({k: torch.from_numpy(v) for k, v in layer.items()}
                        for layer in stack)
    got = strategy.fedavg_step(from_numpy(params, "cpu"), torch_stack,
                               torch.from_numpy(wts))
    want = ref_strategy.fedavg_step(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, stack), jnp.asarray(wts))
    for g, w in zip(np_tree(got), np_tree(want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=1e-6)
    per_round = server.fedavg_update(
        [tuple({k: v[s] for k, v in layer.items()} for layer in torch_stack)
         for s in range(3)], weights=n / n.sum())
    assert _bitwise(got, per_round)
    same = strategy.fedavg_step(from_numpy(params, "cpu"), torch_stack,
                                torch.zeros(4))
    assert _bitwise(same, from_numpy(params, "cpu"))


def test_slot_trainer_takes_a_tensor_lr_bitwise_the_float():
    """A captured round reads the learning rate from a 0-d fp32 tensor that
    is refilled each round; the SGD step is bitwise the float path."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((3, 96, 12)) < 0.3).astype(np.float32))
    y = torch.from_numpy((rng.random((3, 96)) < 0.4).astype(np.float32))
    p0 = from_numpy(np_tree(_stack(7, 1)), "cpu")
    start = tuple({k: v.expand(3, *v.shape[1:]) for k, v in layer.items()}
                  for layer in p0)
    perms = torch.stack([torch.stack([torch.randperm(
        96, generator=torch.Generator().manual_seed(s + e))
        for e in range(2)]) for s in range(3)])
    lr = np.float32(0.0371)
    a = local_train_slots(start, x, y, float(lr), perms, batch_size=32,
                          epochs=2)
    b = local_train_slots(start, x, y, torch.tensor(lr), perms,
                          batch_size=32, epochs=2)
    assert _bitwise(a, b)
    rows = torch.tensor([2, 0, 2])
    c = local_train_slots(start, x, y, torch.tensor(lr), perms,
                          batch_size=32, epochs=2, clients=rows)
    d = local_train_slots(start, x[rows], y[rows], float(lr), perms,
                          batch_size=32, epochs=2)
    assert _bitwise(c, d)


def test_prepare_fused_plan_layout():
    """The plan's (S, B) tables: rows padded with the round's slot 0,
    validity, the identity permutation on padded slots, lr and weights
    zero past the real rounds, zero noise on padded slots."""
    rng = np.random.default_rng(0)
    shards = [(rng.random((n, 6)).astype(np.float32),
               (rng.random(n) < 0.5).astype(np.float32)) for n in (10, 7, 9)]
    eng = engine.BatchedEngine(shards, 4, 2, "cpu")
    parts = [np.array([0, 2]), np.array([], np.int64)]
    perms = [[[rng.permutation(10) for _ in range(2)] for _ in range(2)], []]
    noise = [[torch.ones(2, 3, 4)], [torch.zeros(0, 3, 4)]]
    plan = eng.prepare_fused_plan(parts, [0.5, 0.25], perms, horizon=3,
                                  num_slots=4,
                                  weights=[np.array([0.4, 0.6]),
                                           np.zeros(0)],
                                  noise=noise)
    assert plan.rounds == 2 and plan.num_slots == 4
    assert plan.part_idx.tolist() == [[0, 2, 0, 0], [0] * 4, [0] * 4]
    assert plan.valid.tolist() == [[True, True, False, False],
                                   [False] * 4, [False] * 4]
    assert plan.lrs.tolist() == [0.5, 0.25, 0.0]
    assert torch.equal(plan.perms[0, 1, 1],
                       torch.from_numpy(perms[0][1][1]))
    assert torch.equal(plan.perms[0, 3, 0], torch.arange(10))
    assert torch.equal(plan.perms[2, 0, 1], torch.arange(10))
    assert plan.weights[0].tolist() == pytest.approx([0.4, 0.6, 0.0, 0.0])
    assert plan.weights[1:].abs().sum() == 0
    z, = plan.noise
    assert z.shape == (3, 4, 3, 4)
    assert z[0, :2].eq(1).all() and z[0, 2:].eq(0).all() and \
        z[1:].eq(0).all()


def test_round_program_is_cuda_only_and_keys_by_shape():
    with pytest.raises(ValueError, match="cuda"):
        graphs.RoundProgram(lambda t: t, torch.zeros(2))
    a = graphs.program_key("scbf", torch.zeros(2, 3), None, [torch.ones(4)])
    assert a == graphs.program_key("scbf", torch.ones(2, 3), None,
                                   [torch.zeros(4)])
    assert a != graphs.program_key("scbf", torch.zeros(2, 4), None,
                                   [torch.zeros(4)])
    assert a != graphs.program_key("scbf", torch.zeros(2, 3),
                                   [torch.zeros(1)], [torch.zeros(4)])
