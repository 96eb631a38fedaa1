"""The readers of the program's spans (``harness/spans.py`` and the
``*_ms.mlp`` and ``idle_unspanned.mlp`` metrics) on hand-built windows."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for _p in (str(BENCH), str(BENCH.parent / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import registry, spans  # noqa: E402
from harness.trace import WINDOW, Window  # noqa: E402

CELL = "mlp-scbf-fused"
SPAN_METRICS = ("plan_ms.mlp", "replay_ms.mlp", "encode_ms.mlp",
                "encode_wait_ms.mlp", "record_ms.mlp", "eval_ms.mlp")


def _read(metric, window, loops=2):
    reader = registry.find_cell(CELL).layer_reader(metric)
    return reader.read({"window": window, "loops": loops})


def _window(host, ops=(), start=100.0, end=1100.0):
    host = [(WINDOW, start, end), ("aten::mm", 150.0, 160.0), *host]
    return Window(ops=list(ops), host=host, start_us=start, end_us=end)


# a chunk: plan 100-200 (opened at 50, before the window), replay 200-400,
# encode 400-700 holding two waits (450-550, 600-650); then two records,
# the second holding an evaluation
CHUNK = [("fused_chunk", 40.0, 700.0), ("plan", 50.0, 200.0),
         ("replay", 200.0, 400.0), ("encode", 400.0, 700.0),
         ("encode.wait", 450.0, 550.0), ("encode.wait", 600.0, 650.0),
         ("record", 700.0, 760.0), ("record", 760.0, 1000.0),
         ("eval", 800.0, 950.0)]


def test_the_program_spans_are_the_named_ones():
    w = _window(CHUNK)
    assert [n for n, _, _ in spans.program(w)] == [
        "fused_chunk", "plan", "replay", "encode", "encode.wait",
        "encode.wait", "record", "record", "eval"]
    assert set(spans.PROGRAM_SPANS) == {n for n, _, _ in CHUNK}


def test_self_time_takes_out_the_nested_spans():
    w = _window(CHUNK)
    assert spans.time_us(w, "encode") == 300.0
    assert spans.time_us(w, "encode", self_time=True) == 150.0
    assert spans.time_us(w, "record", self_time=True) == 300.0 - 150.0
    # the chunk less everything inside it, clipped at the window's start
    assert spans.time_us(w, "fused_chunk", self_time=True) == 0.0


def test_spans_are_clipped_at_the_windows_bounds():
    w = _window(CHUNK, end=900.0)
    assert spans.time_us(w, "plan") == 100.0           # 100-200 of 50-200
    assert spans.time_us(w, "record") == 60.0 + 140.0  # 760-900 of 760-1000
    assert spans.time_us(w, "eval") == 100.0
    assert spans.time_us(w, "record", self_time=True) == 60.0 + 40.0
    late = _window([("record", 1000.0, 1200.0), ("eval", 1050.0, 1150.0)])
    assert spans.time_us(late, "record", self_time=True) == 50.0


def test_the_readers_divide_by_the_loops():
    w = _window(CHUNK)
    want = {"plan_ms.mlp": 0.1, "replay_ms.mlp": 0.2, "encode_ms.mlp": 0.15,
            "encode_wait_ms.mlp": 0.15, "record_ms.mlp": 0.15,
            "eval_ms.mlp": 0.15}
    for metric in SPAN_METRICS:
        assert _read(metric, w, loops=1) == pytest.approx(want[metric])
        assert _read(metric, w, loops=4) == pytest.approx(want[metric] / 4)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_window_without_the_span_reads_nothing(metric):
    assert _read(metric, _window([])) is None


def test_gaps_go_to_the_innermost_span_under_their_middle():
    # device busy 100-450 and 560-1000: the gaps 450-560 (middle 505, in
    # the first wait) and 1000-1100 (middle 1050, under no span)
    w = _window(CHUNK, ops=[("k", 100.0, 450.0), ("k", 560.0, 1000.0)])
    idle = spans.idle_by_span(w)
    assert idle == {"encode.wait": pytest.approx(110e-6),
                    None: pytest.approx(100e-6)}
    assert spans.idle_unspanned(w) == pytest.approx(100.0 * 100 / 210)
    assert _read("idle_unspanned.mlp", w) == pytest.approx(100.0 * 100 / 210)
    # a gap whose middle falls on a span's edge is that span's
    edge = _window(CHUNK, ops=[("k", 100.0, 999.0), ("k", 1001.0, 1100.0)])
    assert spans.idle_by_span(edge) == {"record": pytest.approx(2e-6)}


def test_a_window_without_program_spans_is_all_unspanned():
    w = _window([], ops=[("k", 300.0, 500.0)])
    assert _read("idle_unspanned.mlp", w) == 100.0
    assert spans.idle_unspanned(_window(CHUNK, ops=[("k", 100.0, 1100.0)])) \
        == 0.0
