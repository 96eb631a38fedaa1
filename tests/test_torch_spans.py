"""The port's spans on the profiler's clock (``repro_torch.obs.trace.span``):
a fused run under ``torch.profiler`` and no recorder shows every span of
the fused loop, nested as the loop nests them and as many as it runs them;
with no profiler running no span enters ``record_function``; the
recorder's log keeps the reference's spans whether a profiler runs or
not.  The names are those the benchmark reads (``bench/harness/spans.py``).
Small sizes: cohort 600 × 24, MLP 24-8-4-1, 3 clients."""
import importlib.util
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import config as tcfg
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.obs import trace

FEATS = (24, 8, 4, 1)
K, BATCH, SEED, LOOPS, FUSE = 3, 32, 0, 4, 2
CHUNKS = LOOPS // FUSE
BENCH_SPANS = Path(__file__).resolve().parents[1] / "bench" / "harness" / \
    "spans.py"


def _bench_spans():
    spec = importlib.util.spec_from_file_location("bench_harness_spans",
                                                  BENCH_SPANS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cohort():
    return generate_cohort(num_admissions=600, num_medicines=24, seed=SEED)


def _run(cohort, method="scbf"):
    cfg = tcfg.TrainConfig(
        learning_rate=0.05, global_loops=LOOPS, local_batch_size=BATCH,
        seed=SEED,
        scbf=tcfg.ScbfConfig(num_clients=K, upload_rate=0.25),
        fed=tcfg.FedConfig(fuse_rounds=FUSE, engine="batched"))
    return run_federated(cohort, cfg, method=method, mlp_features=FEATS,
                         device="cpu")


def _profiled_spans(cohort):
    """The program's spans of a profiled fused run: {name: [(start, end)]}
    in µs on the profiler's clock."""
    names = set(_bench_spans().PROGRAM_SPANS) | {"round"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(cohort)
    out = {}
    for e in prof.events():
        if e.name in names:
            out.setdefault(e.name, []).append(
                (float(e.time_range.start), float(e.time_range.end)))
    return out


def _inside(inner, outers):
    s, e = inner
    return any(a <= s and e <= b for a, b in outers)


@pytest.fixture(scope="module")
def spans(cohort):
    assert trace.get_recorder() is None
    return _profiled_spans(cohort)


def test_the_fused_loops_spans_nest_as_the_loop_runs_them(spans):
    for name in ("plan", "replay", "encode"):
        assert all(_inside(s, spans["fused_chunk"]) for s in spans[name]), \
            name
    assert all(_inside(s, spans["encode"]) for s in spans["encode.wait"])
    # every evaluation of a loop is a record's; the one before the first
    # chunk scores the initial model
    evals = sorted(spans["eval"])
    assert evals[0][1] <= min(spans["fused_chunk"])[0]
    assert all(_inside(s, spans["record"]) for s in evals[1:])
    assert len(evals) == 1 + CHUNKS
    assert not any(_inside(s, spans["fused_chunk"])
                   for s in spans["record"])


def test_the_fused_loop_runs_each_span_as_often_as_its_work(spans):
    assert len(spans["fused_chunk"]) == CHUNKS
    assert len(spans["plan"]) == len(spans["replay"]) == CHUNKS
    assert len(spans["encode"]) == CHUNKS
    assert len(spans["encode.wait"]) >= CHUNKS
    assert len(spans["record"]) == LOOPS


def test_the_run_emits_the_span_names_the_benchmark_reads(spans):
    assert set(spans) == set(_bench_spans().PROGRAM_SPANS)


def test_a_fedavg_chunk_replays_in_its_span(cohort):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(cohort, method="fedavg")
    names = [e.name for e in prof.events()]
    assert names.count("replay") == names.count("plan") == CHUNKS
    assert "encode" not in names and names.count("record") == LOOPS


def test_no_profiler_no_range(cohort, monkeypatch):
    """Without a profiler or a recorder no span enters a profiler range:
    a span costs its clock reads and one check."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    res = _run(cohort)
    assert len(res.records) == LOOPS


def _logged(rec):
    return [e["name"] for e in rec.events if e["ev"] == "span"]


def test_the_log_keeps_the_references_spans_under_a_profiler(cohort):
    """A recorded run writes the same span events and counters with a
    profiler running as without one; the spans the reference does not
    have reach the profiler only."""
    with trace.recording() as plain:
        _run(cohort)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as profiled:
            _run(cohort)
    assert _logged(profiled) == _logged(plain)
    assert set(_logged(plain)) == {"fused_chunk", "encode", "eval"} \
        < trace.LOGGED
    assert profiled.counters == plain.counters
    seen = {e.name for e in prof.events()}
    assert set(_bench_spans().PROGRAM_SPANS) - trace.LOGGED <= seen
    assert set(_logged(profiled)) <= trace.LOGGED


# the port's spans the reference's log does not have: the fused loop's
# layer boundaries, the LM step's phases (``core/distributed``) and the
# model's layers (``models/layers``, ``models/moe``)
PROFILER_ONLY = ("plan", "replay", "encode.wait", "record", "client_grad",
                 "select", "sum_update", "mla", "moe.route", "moe.experts",
                 "mlp")


@pytest.mark.parametrize("name", PROFILER_ONLY)
def test_a_timeline_span_is_not_logged(name):
    with trace.recording() as rec:
        with trace.span(name) as sp:
            pass
        with trace.span("eval"):
            pass
    assert sp.elapsed >= 0.0
    assert _logged(rec) == ["eval"] and rec.counters["spans"] == 1
