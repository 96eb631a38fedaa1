"""The simulated clock of the port (``repro_torch.fed.clock``) and the
clocked sync plans against the reference's: latencies, availability,
deadlines and plans bitwise equal, and drop and spill runs with the
reference's round events and bytes (draws injected)."""
import numpy as np
import pytest

from repro.core.scbf import run_federated as ref_run
from repro.data.medical import federated_split as ref_split
from repro.data.medical import generate_cohort as ref_cohort
from repro.fed.clock import SimClock as RefClock
from repro.fed.scheduler import SyncScheduler as RefSync
from repro.obs import Recorder as RefRecorder
from repro.obs import recording as ref_recording
from repro_torch import config as tcfg
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.fed.clock import SimClock
from repro_torch.fed.scheduler import SyncScheduler, make_scheduler
from repro_torch.obs import Recorder, recording

from _torch_parity import np_tree, reference_config, reference_draws

DIURNAL = dict(enabled=True, availability_mean=0.7, diurnal_amplitude=0.3,
               day_s=120.0, hetero_sigma=1.0, compute_sigma=0.5)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_clock_draws_are_the_references(seed):
    """Traits, latencies, availability and deadlines bitwise equal over
    rounds and attempts, with the simulated time advancing."""
    cfg = tcfg.ClockConfig(deadline_quantile=0.7, **DIURNAL)
    mine, ref = SimClock(9, cfg, seed), RefClock(9, reference_config(cfg),
                                                 seed)
    assert np.array_equal(mine.speed, ref.speed)
    assert np.array_equal(mine.phase, ref.phase)
    for rnd in range(6):
        for attempt in range(3):
            lat = mine.latencies(rnd, attempt)
            assert np.array_equal(lat, ref.latencies(rnd, attempt))
            assert np.array_equal(mine.available(rnd, attempt),
                                  ref.available(rnd, attempt))
            assert mine.deadline(lat[:5]) == ref.deadline(lat[:5])
        mine.advance(17.5 * (rnd + 1))
        ref.advance(17.5 * (rnd + 1))
    assert mine.now == ref.now
    assert mine.deadline(np.zeros(0)) == 0.0


@pytest.mark.parametrize("action", ["drop", "spill"])
def test_clocked_sync_plans_are_the_references(action):
    """Twelve clocked plans (with retries' attempts) equal field for
    field, the in-flight spills and the referenced rounds too."""
    clock = tcfg.ClockConfig(deadline_quantile=0.6, deadline_action=action,
                             **DIURNAL)
    fed = tcfg.FedConfig(sample_fraction=0.75, clock=clock)
    mine = SyncScheduler(12, fed, 3, clock=SimClock(12, clock, 3))
    ref = RefSync(12, reference_config(fed), 3,
                  clock=RefClock(12, reference_config(clock), 3))
    fields = ("participants", "staleness", "sampled", "dropped",
              "stragglers", "latency_s", "spilled")
    spilled = 0
    for rnd in range(12):
        a, b = mine.plan(rnd, attempt=rnd % 2), ref.plan(rnd,
                                                         attempt=rnd % 2)
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or np.array_equal(x, y), f
        assert a.deadline_s == b.deadline_s and a.attempt == b.attempt
        assert a.telemetry() == b.telemetry()
        assert mine.pending == ref.pending
        assert mine.referenced_rounds() == ref.referenced_rounds()
        spilled += 0 if a.spilled is None else a.spilled.size
    assert (spilled > 0) == (action == "spill")


def test_clock_refusals_are_the_references():
    """The clock replaces the coin flips; fedbuff and the clock exclude
    each other; a quantile outside (0, 1] and an unknown action fail."""
    clock = SimClock(5, tcfg.ClockConfig(enabled=True), 0)
    with pytest.raises(ValueError, match="clock"):
        SyncScheduler(5, tcfg.FedConfig(dropout_rate=0.2), 0, clock=clock)
    with pytest.raises(ValueError, match="at most one"):
        make_scheduler(tcfg.FedConfig(mode="fedbuff"), 5, 0, clock=clock)
    with pytest.raises(ValueError, match="deadline_quantile"):
        SimClock(5, tcfg.ClockConfig(deadline_quantile=0.0))
    with pytest.raises(ValueError, match="deadline_action"):
        SimClock(5, tcfg.ClockConfig(deadline_action="wait"))


FEATS = (40, 16, 4, 1)
CLIENTS = 8


@pytest.fixture(scope="module")
def cohorts():
    kw = dict(num_admissions=800, num_medicines=40, num_risk_medicines=15,
              num_interactions=4, seed=0)
    return ref_cohort(**kw), generate_cohort(**kw)


@pytest.mark.parametrize("action", ["drop", "spill"])
def test_clocked_runs_match_the_reference(cohorts, action):
    """Deadline drop and spill runs (batched engine, 5 loops): each
    round's participants, ``deadline_s``, ``spilled``, staleness and
    bytes equal, the flushes of spill's buffer at the same versions, AUC
    to 1e-3 and final weights to 1e-6 — with the reference's draws
    injected; spill must deliver a late update."""
    rc, pc = cohorts
    loops = 5
    cfg = tcfg.TrainConfig(
        learning_rate=0.05, global_loops=loops, local_batch_size=32,
        local_epochs=1, scbf=tcfg.ScbfConfig(num_clients=CLIENTS),
        fed=tcfg.FedConfig(clock=tcfg.ClockConfig(
            enabled=True, deadline_quantile=0.6, deadline_action=action,
            hetero_sigma=1.0, compute_sigma=0.5)))
    shards = ref_split(rc.x_train, rc.y_train, CLIENTS, seed=0)
    n_max = max(len(y) for _, y in shards)
    init, perms, _ = reference_draws(0, FEATS, [n_max] * CLIENTS, loops, 1)
    ref_rec, rec = RefRecorder(), Recorder()
    with ref_recording(recorder=ref_rec):
        want = ref_run(rc, reference_config(cfg), mlp_features=FEATS)
    with recording(recorder=rec):
        got = run_federated(pc, cfg, mlp_features=FEATS, device="cpu",
                            init_params=init, perms=perms)
    keys = ("participants", "sparse_bytes", "dense_bytes", "deadline_s",
            "spilled", "stragglers", "staleness_mean", "staleness_max",
            "latency_mean_s", "attempt")

    def rounds(r):
        return [tuple(e.get(k) for k in keys) for e in r.events
                if e["ev"] == "round"]

    def flushes(r):
        return [(e["version"], e["buffered"]) for e in r.events
                if e["ev"] == "fedbuff_flush"]

    assert rounds(rec) == rounds(ref_rec)
    assert flushes(rec) == flushes(ref_rec)
    assert (max(e[6] for e in rounds(rec)) > 0) == (action == "spill")
    assert any(e[0] < CLIENTS for e in rounds(rec))
    for g, w in zip(got.records, want.records):
        np.testing.assert_allclose(g.auc_roc, w.auc_roc, atol=1e-3)
        np.testing.assert_allclose(g.auc_pr, w.auc_pr, atol=1e-3)
    for lg, lw in zip(np_tree(got.final_params), np_tree(want.final_params)):
        for k in lw:
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-6, rtol=0)
