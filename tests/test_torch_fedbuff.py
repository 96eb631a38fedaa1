"""FedBuff in the port against the reference: the scheduler's plans, the
staleness-weighted buffer, a slot pass from stale per-slot starts, and
whole FedBuff runs (plain and with mask-mode pruning) with the
reference's draws injected."""
import numpy as np
import pytest
import torch

from repro.comm import wire as ref_wire
from repro.core.scbf import run_federated as ref_run
from repro.data.medical import federated_split as ref_split
from repro.data.medical import generate_cohort as ref_cohort
from repro.fed.scheduler import FedBuffScheduler as RefFedBuffScheduler
from repro.fed.strategy import FedBuff as RefFedBuff
from repro.fed.strategy import RoundContribution as RefContribution
from repro.obs import Recorder as RefRecorder
from repro.obs import recording as ref_recording
from repro_torch import config as tcfg
from repro_torch.comm import wire
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.fed.engine import BatchedEngine, _slot_pass, _stack_params
from repro_torch.fed.scheduler import FedBuffScheduler
from repro_torch.fed.strategy import FedBuff, RoundContribution
from repro_torch.obs import Recorder, recording

from _torch_parity import np_tree, reference_config, reference_draws

FEDBUFF = dict(mode="fedbuff", concurrency=5, buffer_size=3,
               straggler_rate=0.3, dropout_rate=0.05)


def test_fedbuff_plans_are_the_references():
    """Twenty plans equal field for field, the server version advancing
    as a flush would; in-flight clients and referenced versions too."""
    fed = tcfg.FedConfig(**FEDBUFF)
    mine = FedBuffScheduler(12, fed, 4)
    ref = RefFedBuffScheduler(12, reference_config(fed), 4)
    version, stale = 0, 0
    for rnd in range(20):
        a, b = mine.plan(rnd, version), ref.plan(rnd, version)
        for f in ("participants", "staleness", "sampled", "dropped",
                  "stragglers"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert a.telemetry() == b.telemetry()
        assert mine.in_flight == ref.in_flight
        assert mine.referenced_versions() == ref.referenced_versions()
        version += rnd % 3 == 1
        stale = max(stale, int(a.staleness.max(initial=0)))
    assert stale > 0


def test_fedbuff_horizon_above_one_is_refused():
    """FedBuff plans need the version of each previous round: both
    packages refuse a horizon above 1 with the same error."""
    fed = tcfg.FedConfig(**FEDBUFF)
    for sched in (FedBuffScheduler(4, fed),
                  RefFedBuffScheduler(4, reference_config(fed))):
        assert len(sched.plan_horizon(0, 1)) == 1
        with pytest.raises(ValueError, match="horizon=1 only"):
            sched.plan_horizon(0, 2)


def _tree(rng, scale=1.0, nan=False):
    w = rng.standard_normal((6, 4)).astype(np.float32) * scale
    w[rng.random((6, 4)) < 0.6] = 0.0
    if nan:
        w[0, 0] = np.nan
    return [{"w": w, "b": rng.standard_normal(4).astype(np.float32)},
            {"w": rng.standard_normal((4, 1)).astype(np.float32),
             "b": np.zeros(1, np.float32)}]


def test_fedbuff_aggregate_is_the_references():
    """The same uploads through both buffers (staleness weights, a flush
    each time it fills, a NaN upload rejected without a policy): the same
    flush events, versions and buffer counts, params to 1e-6."""
    rng = np.random.default_rng(0)
    start = _tree(rng)
    rounds = [([_tree(rng) for _ in range(n)], rng.integers(0, 4, n))
              for n in (2, 4, 1, 3)]
    rounds[1][0][2] = _tree(rng, nan=True)
    mine = FedBuff(buffer_size=3, staleness_exponent=0.5, server_lr=0.7)
    ref = RefFedBuff(buffer_size=3, staleness_exponent=0.5, server_lr=0.7)
    s_mine = mine.init(tuple({k: torch.from_numpy(v.copy())
                              for k, v in layer.items()} for layer in start))
    s_ref = ref.init(tuple(start))
    rec, ref_rec = Recorder(), RefRecorder()
    for trees, tau in rounds:
        with recording(recorder=rec):
            s_mine = mine.aggregate(s_mine, RoundContribution(
                num_examples=np.ones(len(trees)), staleness=tau,
                payloads=[wire.encode(t) for t in trees]))
        with ref_recording(recorder=ref_rec):
            s_ref = ref.aggregate(s_ref, RefContribution(
                num_examples=np.ones(len(trees)), staleness=tau,
                payloads=[ref_wire.encode(tuple(t)) for t in trees]))
        assert (s_mine.version, s_mine.buffer_count) == \
            (s_ref.version, s_ref.buffer_count)

    def flushes(r):
        return [(e["ev"], e.get("version"), e.get("buffered"),
                 e.get("reason")) for e in r.events[1:]]

    assert flushes(rec) == flushes(ref_rec)
    assert s_mine.version == 3
    for lg, lw in zip(np_tree(s_mine.params), np_tree(s_ref.params)):
        for k in lw:
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-6, rtol=0)


def test_stacked_slot_pass_is_its_one_slot_runs():
    """A slot pass whose slots start from different params (stale
    versions) equals, slot for slot and bitwise, a pass of each slot
    alone from its own params."""
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((3, 130, 12), generator=g) < 0.3).float()
    y = (torch.rand((3, 130), generator=g) < 0.4).float()
    eng = BatchedEngine([(x[k].numpy(), y[k].numpy()) for k in range(3)],
                        batch_size=32, epochs=2, device="cpu")
    starts = [tuple({"w": torch.randn((a, b), generator=g) * 0.3,
                     "b": torch.randn((b,), generator=g) * 0.1}
                    for a, b in ((12, 8), (8, 4), (4, 1)))
              for _ in range(3)]
    cfg = tcfg.ScbfConfig(upload_rate=0.2)
    perms = torch.stack([torch.stack([torch.randperm(130, generator=g)
                                      for _ in range(2)])
                         for _ in range(4)])
    rows = torch.tensor([2, 0, 1, 2])
    valid = torch.tensor([True, True, True, False])
    masked, masks = _slot_pass(
        _stack_params(starts, 4), eng.cohort, rows, valid, 0.05, perms, cfg,
        batch_size=32, epochs=2)
    for s in range(3):
        one, one_masks = _slot_pass(
            starts[s], eng.cohort, rows[s:s + 1], valid[s:s + 1], 0.05,
            perms[s:s + 1], cfg, batch_size=32, epochs=2)
        for layer, ref_layer in zip(masked, one):
            for k in layer:
                assert torch.equal(layer[k][s], ref_layer[k][0])
        for layer, ref_layer in zip(masks, one_masks):
            for k in layer:
                assert torch.equal(layer[k][s], ref_layer[k][0])
    assert all(not torch.any(layer[k][3]) for layer in masked
               for k in layer)


FEATS = (40, 16, 4, 1)
CLIENTS = 8


@pytest.fixture(scope="module")
def cohorts():
    kw = dict(num_admissions=800, num_medicines=40, num_risk_medicines=15,
              num_interactions=4, seed=0)
    return ref_cohort(**kw), generate_cohort(**kw)


@pytest.mark.parametrize("engine", ["batched", "sequential"])
@pytest.mark.parametrize("scbf", [
    {}, dict(prune=True, prune_impl="mask", prune_rate=0.25,
             prune_total=0.4)], ids=["scbf", "scbfwp-mask"])
def test_fedbuff_run_matches_the_reference(cohorts, scbf, engine):
    """A FedBuff run (6 loops, 8 clients, concurrency 5, buffer 3): per
    loop the same participants, staleness and bytes, flushes at the same
    versions, hidden sizes, AUC to 1e-3 and final weights to 1e-6 — with
    the reference's draws injected; some round trains from stale
    versions."""
    rc, pc = cohorts
    loops = 6
    cfg = tcfg.TrainConfig(
        learning_rate=0.05, global_loops=loops, local_batch_size=32,
        local_epochs=1,
        scbf=tcfg.ScbfConfig(num_clients=CLIENTS, **scbf),
        fed=tcfg.FedConfig(engine=engine, **FEDBUFF))
    shards = ref_split(rc.x_train, rc.y_train, CLIENTS, seed=0)
    sizes = [len(y) for _, y in shards]
    if engine == "batched":
        sizes = [max(sizes)] * CLIENTS
    init, perms, _ = reference_draws(0, FEATS, sizes, loops, 1)
    ref_rec, rec = RefRecorder(), Recorder()
    with ref_recording(recorder=ref_rec):
        want = ref_run(rc, reference_config(cfg), mlp_features=FEATS)
    with recording(recorder=rec):
        got = run_federated(pc, cfg, mlp_features=FEATS, device="cpu",
                            init_params=init, perms=perms)
    keys = ("participants", "sparse_bytes", "dense_bytes", "staleness_mean",
            "staleness_max", "sampled", "dropped", "stragglers", "hidden")

    def rounds(r):
        return [tuple(str(e.get(k)) for k in keys) for e in r.events
                if e["ev"] == "round"]

    def flushes(r):
        return [(e["version"], e["buffered"]) for e in r.events
                if e["ev"] == "fedbuff_flush"]

    assert rounds(rec) == rounds(ref_rec)
    assert flushes(rec) == flushes(ref_rec) and len(flushes(rec)) >= 3
    assert max(e["staleness_max"] for e in rec.events
               if e["ev"] == "round") > 0
    for g, w in zip(got.records, want.records):
        assert g.hidden_sizes == w.hidden_sizes
        np.testing.assert_allclose(g.auc_roc, w.auc_roc, atol=1e-3)
        np.testing.assert_allclose(g.auc_pr, w.auc_pr, atol=1e-3)
    for lg, lw in zip(np_tree(got.final_params), np_tree(want.final_params)):
        for k in lw:
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-6, rtol=0)
    if scbf:
        assert sum(got.records[-1].hidden_sizes) < sum(FEATS[1:3])


@pytest.mark.parametrize("change,match", [
    (dict(method="fedavg"), "method must be 'scbf'"),
    (dict(scbf=dict(prune=True)), "prune_impl='mask'"),
    (dict(fed=dict(min_valid_participants=2)), "needs sync mode"),
    (dict(scbf=dict(dp_noise_multiplier=1.0, dp_amplification=True)),
     "fedbuff participation"),
], ids=["fedavg", "reshape-prune", "quorum", "dp-amplification"])
def test_fedbuff_refusals_are_the_references(cohorts, change, match):
    """What the reference refuses under FedBuff the port refuses with
    the same ValueError."""
    rc, pc = cohorts
    cfg = tcfg.TrainConfig(
        global_loops=1,
        scbf=tcfg.ScbfConfig(num_clients=4, **change.get("scbf", {})),
        fed=tcfg.FedConfig(**{**FEDBUFF, **change.get("fed", {})}))
    method = change.get("method", "scbf")
    with pytest.raises(ValueError, match=match):
        ref_run(rc, reference_config(cfg), method=method,
                mlp_features=FEATS)
    with pytest.raises(ValueError, match=match):
        run_federated(pc, cfg, method=method, mlp_features=FEATS,
                      device="cpu")
