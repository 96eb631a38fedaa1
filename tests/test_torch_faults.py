"""The chaos oracles of ``tests/test_chaos.py`` held against the
reference: fault injection, sealing, the admission gate, the fused
admit mask and the round quorum of the port
(``repro_torch.fed.faults``, ``.strategy``, ``.comm.wire``) give the
reference's events, rejection reasons, counters and bytes on the same
cohort with the reference's draws injected; fused runs equal per-round
runs bitwise; the refusals raise the reference's ValueError."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.comm import wire as ref_wire
from repro.core.scbf import run_federated as ref_run
from repro.data.medical import federated_split as ref_split
from repro.data.medical import generate_cohort as ref_cohort
from repro.fed import faults as ref_faults
from repro.fed.strategy import AdmissionPolicy as RefPolicy
from repro.fed.strategy import RoundContribution as RefContribution
from repro.fed.strategy import ServerState as RefState
from repro.fed.strategy import admit_payloads as ref_admit
from repro.obs import Recorder as RefRecorder
from repro.obs import recording as ref_recording
from repro_torch import config as tcfg
from repro_torch.comm import wire
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.fed import faults
from repro_torch.fed.strategy import (AdmissionPolicy, RoundContribution,
                                      ServerState, admit_payloads)
from repro_torch.obs import Recorder, recording

from _torch_parity import np_tree, reference_config, reference_draws

FEATS = (40, 16, 4, 1)
CLIENTS = 5
STORM = tcfg.FaultConfig(enabled=True, seed=7, crash_rate=0.15,
                         net_fail_rate=0.15, duplicate_rate=0.2,
                         bitflip_rate=0.15, nan_rate=0.15, poison_rate=0.15)
REJECTIONS = ("payloads_rejected", "rejected_malformed",
              "rejected_checksum", "rejected_duplicate",
              "rejected_nonfinite", "rejected_norm", "payloads_clipped",
              "rounds_retried", "quorum_misses")


@pytest.fixture(scope="module")
def cohorts():
    kw = dict(num_admissions=800, num_medicines=40, num_risk_medicines=15,
              num_interactions=4, seed=0)
    rc = ref_cohort(**kw)
    shards = ref_split(rc.x_train, rc.y_train, CLIENTS, seed=0)
    n_max = max(len(y) for _, y in shards)
    return rc, generate_cohort(**kw), n_max


def _cfg(fuse=1, loops=4, faults=None, max_norm=0.0, **fed_kw):
    """``tests/test_chaos.py``'s config, as a port config."""
    return tcfg.TrainConfig(
        learning_rate=0.05, global_loops=loops, local_batch_size=64,
        local_epochs=1, eval_every=loops,
        scbf=tcfg.ScbfConfig(upload_rate=0.1, num_clients=CLIENTS),
        fed=tcfg.FedConfig(fuse_rounds=fuse,
                           faults=faults or tcfg.FaultConfig(),
                           max_update_norm=max_norm, **fed_kw))


def _port(cohorts, cfg):
    """(result, recorder) of a port run, the reference's draws
    injected."""
    _, pc, n_max = cohorts
    init, perms, _ = reference_draws(0, FEATS, [n_max] * CLIENTS,
                                     cfg.global_loops, 1)
    rec = Recorder()
    with recording(recorder=rec):
        res = run_federated(pc, cfg, mlp_features=FEATS, device="cpu",
                            init_params=init, perms=perms)
    return res, rec


def _ref(cohorts, cfg):
    rec = RefRecorder()
    with ref_recording(recorder=rec):
        res = ref_run(cohorts[0], reference_config(cfg), mlp_features=FEATS)
    return res, rec


def _chaos_events(rec):
    """Every chaos event, its clock and telemetry fields aside."""
    keep = ("fault_injected", "payload_rejected", "round_retried",
            "quorum_miss")
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in rec.events if e["ev"] in keep]


def _counts(rec):
    return {k: rec.counters.get(k, 0) for k in REJECTIONS}


def _params_equal(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def _finite(params):
    return all(bool(torch.isfinite(layer[k]).all()) for layer in params
               for k in layer)


def _assert_like_reference(got, want):
    (res, rec), (ref_res, ref_rec) = got, want
    assert _chaos_events(rec) == _chaos_events(ref_rec)
    assert _counts(rec) == _counts(ref_rec)
    for g, w in zip(res.records, ref_res.records):
        assert (g.num_participants, g.sparse_bytes, g.dense_bytes,
                g.upload_fraction) == (w.num_participants, w.sparse_bytes,
                                       w.dense_bytes, w.upload_fraction)
        np.testing.assert_allclose(g.auc_roc, w.auc_roc, atol=1e-3)
        np.testing.assert_allclose(g.auc_pr, w.auc_pr, atol=1e-3)
    for lg, lw in zip(np_tree(res.final_params),
                      np_tree(ref_res.final_params)):
        for k in lw:
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# zero injection: an armed fault model with zero rates changes nothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fuse", [1, 2], ids=["per-round", "fused"])
def test_zero_injection_bit_parity(cohorts, fuse):
    """Armed with every rate zero equals disarmed, bitwise: records and
    final params, on the per-round and the fused path."""
    plain, _ = _port(cohorts, _cfg(fuse=fuse))
    armed, rec = _port(cohorts, _cfg(
        fuse=fuse, faults=tcfg.FaultConfig(enabled=True)))
    assert [dataclasses.replace(r, wall_time=0.0) for r in plain.records] \
        == [dataclasses.replace(r, wall_time=0.0) for r in armed.records]
    assert _params_equal(plain.final_params, armed.final_params)
    assert _counts(rec) == dict.fromkeys(REJECTIONS, 0)


# ---------------------------------------------------------------------------
# storms against the reference
# ---------------------------------------------------------------------------

STORMS = {
    "nan": (dict(seed=3, nan_rate=1.0), 0.0),
    "bitflip": (dict(seed=5, bitflip_rate=1.0), 0.0),
    "duplicate": (dict(seed=11, duplicate_rate=1.0), 0.0),
    "poison": (dict(seed=13, poison_rate=1.0, poison_scale=64.0), 10.0),
}


@pytest.mark.parametrize("name", sorted(STORMS))
def test_storm_matches_the_reference(cohorts, name):
    """One fault kind on every client of every round: the same
    ``fault_injected`` events (kind, client, loop, attempt), the same
    ``payload_rejected`` reasons for the same (client, round), the same
    counters and bytes as the reference; params finite."""
    spec, bound = STORMS[name]
    cfg = _cfg(faults=tcfg.FaultConfig(enabled=True, **spec),
               max_norm=bound)
    got, want = _port(cohorts, cfg), _ref(cohorts, cfg)
    _assert_like_reference(got, want)
    res, rec = got
    assert _finite(res.final_params)
    reason = {"nan": "nonfinite", "bitflip": ("checksum", "malformed"),
              "duplicate": "duplicate", "poison": "norm"}[name]
    reasons = {e["reason"] for e in rec.events
               if e["ev"] == "payload_rejected"}
    assert reasons and reasons <= set(np.atleast_1d(reason))
    if name == "duplicate":
        # the replays are dropped by their nonce: bytes double, the model
        # is the fault-free one
        plain, _ = _port(cohorts, _cfg())
        assert _params_equal(plain.final_params, res.final_params)
        assert [2 * r.sparse_bytes for r in plain.records] == \
            [r.sparse_bytes for r in res.records]


def test_full_storm_matches_the_reference_and_fused_is_bitwise(cohorts):
    """Every fault class at once under the reject gate (6 loops): the
    reference's events, reasons, counters and bytes; the fused run at
    ``fuse_rounds`` = 3 bitwise the per-round run with the same
    counters."""
    cfg = _cfg(loops=6, faults=STORM, max_norm=100.0)
    got = _port(cohorts, cfg)
    _assert_like_reference(got, _ref(cohorts, cfg))
    fused = _port(cohorts, dataclasses.replace(
        cfg, fed=dataclasses.replace(cfg.fed, fuse_rounds=3)))
    assert _params_equal(got[0].final_params, fused[0].final_params)
    assert _counts(got[1]) == _counts(fused[1])
    # the fused loop plans (and injects) a chunk's rounds before it runs
    # the gate on them: the same events, kind by kind
    for kind in ("fault_injected", "payload_rejected"):
        assert [e for e in _chaos_events(got[1]) if e["ev"] == kind] == \
            [e for e in _chaos_events(fused[1]) if e["ev"] == kind]
    assert [(r.sparse_bytes, r.num_participants) for r in got[0].records] \
        == [(r.sparse_bytes, r.num_participants) for r in fused[0].records]
    reasons = {e["reason"] for e in got[1].events
               if e["ev"] == "payload_rejected"}
    assert {"checksum", "duplicate", "nonfinite", "norm"} <= reasons


def test_norm_clip_matches_the_reference(cohorts):
    """``norm_action='clip'`` scales over-norm updates into the bound
    (per round): as many clipped as the reference, none rejected."""
    cfg = _cfg(max_norm=1e-3, norm_action="clip")
    got = _port(cohorts, cfg)
    _assert_like_reference(got, _ref(cohorts, cfg))
    assert got[1].counters.get("payloads_clipped", 0) > 0
    assert got[1].counters.get("rejected_norm", 0) == 0


@pytest.mark.parametrize("fuse", [1, 3], ids=["per-round", "fused"])
def test_quorum_retry_matches_the_reference(cohorts, fuse):
    """A NaN rate that misses a quorum of 4 on some first attempts and
    meets it on a retry: the reference's retries, events and counters,
    on both paths."""
    cfg = _cfg(fuse=fuse, loops=6,
               faults=tcfg.FaultConfig(enabled=True, seed=17, nan_rate=0.35),
               min_valid_participants=4, round_retries=3)
    got = _port(cohorts, cfg)
    _assert_like_reference(got, _ref(cohorts, cfg))
    assert got[1].counters.get("rounds_retried", 0) > 0
    assert got[1].counters.get("quorum_misses", 0) == 0


def test_quorum_miss_matches_the_reference(cohorts):
    """crash_rate=1 never meets a quorum: every round retries twice, then
    misses; the model does not move."""
    cfg = _cfg(loops=3,
               faults=tcfg.FaultConfig(enabled=True, seed=2, crash_rate=1.0),
               min_valid_participants=2, round_retries=2)
    got = _port(cohorts, cfg)
    _assert_like_reference(got, _ref(cohorts, cfg))
    assert got[1].counters.get("rounds_retried") == 3 * 2
    assert got[1].counters.get("quorum_misses") == 3
    start, _ = _port(cohorts, _cfg(loops=0))
    assert _params_equal(got[0].final_params, start.final_params)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

REFUSALS = {
    "fused-norm-gate": (dict(fuse=2, max_norm=1.0), "scbf", "norm gate"),
    "fused-clip": (dict(fuse=2, faults=tcfg.FaultConfig(
        enabled=True, poison_rate=0.5), max_norm=1.0, norm_action="clip"),
        "scbf", "clip"),
    "fused-poison": (dict(fuse=2, faults=tcfg.FaultConfig(
        enabled=True, poison_rate=0.5)), "scbf", "poison"),
    "fedavg-faults": (dict(faults=tcfg.FaultConfig(enabled=True)),
                      "fedavg", "fault injection"),
    "fedavg-norm": (dict(max_norm=1.0), "fedavg", "max_update_norm"),
    "quorum-unreachable": (dict(min_valid_participants=6), "scbf",
                           "can never be met"),
    "spill-fedavg": (dict(clock=tcfg.ClockConfig(
        enabled=True, deadline_action="spill")), "fedavg", "spilling"),
    "clock-coinflips": (dict(clock=tcfg.ClockConfig(enabled=True),
                             dropout_rate=0.1), "scbf", "clock"),
    "rates": (dict(faults=tcfg.FaultConfig(enabled=True, crash_rate=1.5)),
              "scbf", "crash_rate"),
    "norm-action": (dict(max_norm=1.0, norm_action="halve"), "scbf",
                    "norm_action"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_are_the_references(cohorts, name):
    """Each configuration the reference refuses, the port refuses before
    training, with the same ValueError."""
    kw, method, match = REFUSALS[name]
    cfg = _cfg(loops=1, **kw)
    with pytest.raises(ValueError, match=match):
        ref_run(cohorts[0], reference_config(cfg), method=method,
                mlp_features=FEATS)
    with pytest.raises(ValueError, match=match):
        run_federated(cohorts[1], cfg, method=method, mlp_features=FEATS,
                      device="cpu")


def test_spill_with_pruning_is_refused(cohorts):
    cfg = dataclasses.replace(
        _cfg(loops=1, clock=tcfg.ClockConfig(enabled=True,
                                             deadline_action="spill")),
        scbf=tcfg.ScbfConfig(num_clients=CLIENTS, prune=True,
                             prune_impl="mask"))
    for run, c, co in ((ref_run, reference_config(cfg), cohorts[0]),
                       (run_federated, cfg, cohorts[1])):
        kw = {} if run is ref_run else {"device": "cpu"}
        with pytest.raises(ValueError, match="deadline_action='drop'"):
            run(co, c, mlp_features=FEATS, **kw)


# ---------------------------------------------------------------------------
# the wire envelope, the gate on its own, and the CLI spec parser
# ---------------------------------------------------------------------------

def _trees():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((40, 16)).astype(np.float32)
    w[rng.random((40, 16)) < 0.9] = 0.0
    b = np.zeros(16, np.float32)
    b[3] = 0.25
    return [({"w": w, "b": b}, {"w": rng.standard_normal(
        (16, 1)).astype(np.float32), "b": np.zeros(1, np.float32)}),
        ({"w": np.where(w != 0, w, 1.0).astype(np.float32), "b": b},)]


@pytest.mark.parametrize("which", [0, 1], ids=["coo-bitmap-dense", "dense"])
def test_seal_gives_the_references_checksum(which):
    """The same numpy tree encodes and seals to the reference's CRC-32,
    in the port's buffers (int32 idx, fp32 values, uint8 bitmap); a bit
    flip drawn from one stream hits the same bit in both packages and
    fails verification."""
    tree = _trees()[which]
    mine = wire.seal(wire.encode(tree), 3, 7)
    ref = ref_wire.seal(ref_wire.encode(tree), 3, 7)
    assert mine.meta.checksum == ref.meta.checksum
    assert mine.meta.nonce == ref.meta.nonce == (3, 7)
    assert [lp.codec for lp in mine.layers] == \
        [lp.codec for lp in ref.layers]
    assert wire.verify_checksum(mine)
    assert wire.verify_checksum(wire.encode(tree))      # unsealed
    for slot in range(4):
        rng = np.random.default_rng([slot])
        bad = faults.corrupt_wire_payload(mine, rng)
        ref_bad = ref_faults.corrupt_wire_payload(
            ref, np.random.default_rng([slot]))
        assert not wire.verify_checksum(bad)
        for x, y in zip(bad.layers, ref_bad.layers):
            for f in ("values", "idx", "bitmap"):
                fx, fy = getattr(x, f), getattr(y, f)
                assert (fx is None and fy is None) or \
                    np.array_equal(fx, np.asarray(fy), equal_nan=True), f


def test_admission_gate_reasons_are_the_references():
    """One call, every verdict (ok, checksum, duplicate, nonfinite, over
    norm, malformed), in both packages: the same kept indices, events
    and counters."""
    good, _ = _trees()

    def payloads(w):
        over = ({"w": np.full((40, 16), 100.0, np.float32),
                 "b": np.zeros(16, np.float32)}, good[1])
        nan = ({"w": np.where(good[0]["w"] != 0, np.nan, 0.0)
                .astype(np.float32), "b": good[0]["b"]}, good[1])
        ok = w.seal(w.encode(good), 0, 0)
        flip = ref_faults.corrupt_wire_payload(w.seal(w.encode(good), 1, 0),
                                               np.random.default_rng(1)) \
            if w is ref_wire else faults.corrupt_wire_payload(
                w.seal(w.encode(good), 1, 0), np.random.default_rng(1))
        lp = ok.layers[0]
        bad = dataclasses.replace(ok, layers=(dataclasses.replace(
            lp, nnz=lp.size + 1),) + ok.layers[1:])
        return [ok, flip, w.seal(w.encode(good), 0, 0),
                w.seal(w.encode(nan), 2, 0), w.seal(w.encode(over), 3, 0),
                bad]

    rec, ref_rec = Recorder(), RefRecorder()
    with recording(recorder=rec):
        _, kept = admit_payloads(
            ServerState(params=()), RoundContribution(
                num_examples=np.ones(6), staleness=np.zeros(6),
                payloads=payloads(wire)), AdmissionPolicy(10.0))
    with ref_recording(recorder=ref_rec):
        _, ref_kept = ref_admit(
            RefState(params=()), RefContribution(
                num_examples=np.ones(6), staleness=np.zeros(6),
                payloads=payloads(ref_wire)), RefPolicy(10.0))
    assert kept == ref_kept == [0]
    assert _chaos_events(rec) == _chaos_events(ref_rec)
    assert _counts(rec) == _counts(ref_rec)
    assert rec.counters["payloads_rejected"] == 5


def test_fault_outcomes_are_the_references():
    """``FaultInjector.round_faults`` and the client-side corruptions
    equal the reference's, for every attempt of a few rounds."""
    cfg = tcfg.FaultConfig(enabled=True, seed=9, crash_rate=0.2,
                           net_fail_rate=0.3, duplicate_rate=0.3,
                           bitflip_rate=0.2, nan_rate=0.2, poison_rate=0.2)
    mine = faults.FaultInjector(8, cfg)
    ref = ref_faults.FaultInjector(8, reference_config(cfg))
    part = np.array([0, 2, 3, 5, 7])
    for rnd in range(4):
        for attempt in range(2):
            a = mine.round_faults(rnd, part, attempt)
            b = ref.round_faults(rnd, part, attempt)
            for f in ("crashed", "net_lost", "net_tries", "net_delay_s",
                      "duplicated", "corrupt"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert a.events() == b.events()
    tree = _trees()[0]
    for code in (faults.CORRUPT_NAN, faults.CORRUPT_POISON):
        x = faults.corrupt_client_payload(wire.encode(tree), code,
                                          np.random.default_rng(2), 5.0,
                                          16.0)
        y = ref_faults.corrupt_client_payload(ref_wire.encode(tree), code,
                                              np.random.default_rng(2), 5.0,
                                              16.0)
        for lx, ly in zip(x.layers, y.layers):
            np.testing.assert_array_equal(lx.values, np.asarray(ly.values))


def test_parse_fault_trace_is_the_references():
    spec = ("seed=4,crash=0.1,net_fail=0.2,retries=5,backoff=2.5,"
            "duplicate=0.3,bitflip=0.01,nan=0.02,poison=0.03,"
            "poison_scale=8")
    got = faults.parse_fault_trace(spec)
    assert reference_config(got) == ref_faults.parse_fault_trace(spec)
    assert got.enabled and got.net_retries == 5 and got.poison_scale == 8.0
    for bad, match in (("crash=0.1,warp=9", "unknown"), ("crash", "key=")):
        with pytest.raises(ValueError, match=match):
            faults.parse_fault_trace(bad)
        with pytest.raises(ValueError, match=match):
            ref_faults.parse_fault_trace(bad)
    with pytest.raises(ValueError, match="<= 1"):
        faults.FaultInjector(4, tcfg.FaultConfig(
            enabled=True, bitflip_rate=0.5, nan_rate=0.4, poison_rate=0.4))
