"""The port's flight recorder (``repro_torch.obs.trace``) against the
reference's (``repro.obs.trace``): the same calls give the same events
and counters, the same events the same Chrome trace, and a log of the
port reads with the reference's report reader."""
import json

import numpy as np

from repro.obs import report
from repro.obs import trace as ref_trace
from repro_torch import config as tcfg
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.obs import trace


def _drive(mod):
    """One script of calls against a trace module: with and without an
    active recorder, nested spans, events and counters."""
    mod.event("ignored", x=1)                 # no recorder: no-op
    mod.count("ignored")
    with mod.span("free") as sp:
        pass
    assert sp.elapsed >= 0.0
    rec = mod.Recorder()
    with mod.recording(recorder=rec) as active:
        assert active is rec and mod.get_recorder() is rec
        mod.event("run_start", method="scbf", loops=2)
        with mod.span("round", loop=0):
            mod.event("fault_injected", loop=0, attempt=0, fault="crash",
                      client=3)
            mod.count("payloads_rejected")
            mod.count("rejected_checksum", 2)
            # a span of the reference's log (``trace.LOGGED``): the port
            # logs no other
            with mod.span("encode", clients=1):
                pass
        mod.event("run_end", **rec.counters)
    assert mod.get_recorder() is None
    return rec


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_same_calls_give_the_same_events_and_counters():
    """Events (without their clock fields), their order, and counters are
    equal; the schema version is the reference's."""
    mine, ref = _drive(trace), _drive(ref_trace)
    assert trace.EVENT_SCHEMA == ref_trace.EVENT_SCHEMA
    want = _untimed(ref.events)
    got = _untimed(mine.events)
    assert got[0] == {**want[0], "emitter": trace.EMITTER}
    assert got[1:] == want[1:]
    assert mine.counters == ref.counters
    assert all(isinstance(e["ts"], float) for e in mine.events)


def test_chrome_trace_is_the_references():
    """``to_chrome_trace`` of one event stream is the reference's, the
    emitter's name aside."""
    events = _drive(ref_trace).events
    mine, ref = trace.to_chrome_trace(events), \
        ref_trace.to_chrome_trace(events)
    assert mine["traceEvents"] == ref["traceEvents"]
    assert mine["displayTimeUnit"] == ref["displayTimeUnit"]
    assert mine["otherData"] == {"emitter": trace.EMITTER}
    assert [e["ph"] for e in mine["traceEvents"]].count("X") == 2


def test_recording_writes_a_log_the_report_reads(tmp_path):
    """A run of the port under ``recording(path)`` writes events.jsonl
    that ``repro.obs.report`` loads, summarises and tabulates, with the
    reference's spans and device metrics."""
    path = str(tmp_path / "events.jsonl")
    cohort = generate_cohort(num_admissions=600, num_medicines=24, seed=0)
    cfg = tcfg.TrainConfig(learning_rate=0.05, global_loops=2,
                           local_batch_size=64,
                           scbf=tcfg.ScbfConfig(num_clients=3))
    with trace.recording(path) as rec:
        res = run_federated(cohort, cfg, mlp_features=(24, 8, 4, 1),
                            device="cpu")
    events = report.read_events(path)
    assert [e["ev"] for e in events if e["ev"] != "span"] == \
        ["meta", "run_start", "round", "round", "run_end"]
    summary = report.summarize(events)
    assert json.loads(json.dumps(summary))
    assert "loop" in report.per_round_table(events)
    rounds = [e for e in events if e["ev"] == "round"]
    assert [e["sparse_bytes"] for e in rounds] == \
        [r.sparse_bytes for r in res.records]
    assert np.allclose([e["wall"] for e in rounds],
                       [r.wall_time for r in res.records], atol=1e-6)
    end = events[-1]
    assert res.telemetry == {k: v for k, v in end.items()
                             if k not in ("ev", "ts")}
    assert rec.counters["events"] == res.telemetry["events"] + 1
    # the reference's spans: a batched round encodes inside its round span,
    # and evaluation follows it
    spans = [e for e in events if e["ev"] == "span"]
    assert [s["name"] for s in spans] == ["encode", "round", "eval"] * 2
    # a recorded run collects the device metrics, as the reference's does
    for e, r in zip(rounds, res.records):
        assert e["train_loss"] == r.train_loss and r.train_loss > 0
        assert len(e["selected"]) == 3
        assert sum(e["codec_bytes"].values()) == e["sparse_bytes"]
    assert end["host_offloads"] == 2
