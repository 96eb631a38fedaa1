"""Host-side flight recorder — spans, events and the run event log (port
of ``repro.obs.trace``).

``Recorder``
    An append-only event log.  Every event is one JSON-able dict with an
    ``ev`` kind and a monotonic ``ts`` (seconds since the recorder
    started).  ``write()`` dumps the log as JSONL, in the reference's
    ``events.jsonl`` schema (``EVENT_SCHEMA``), which
    ``python -m repro.obs.report`` renders.

``recording(...)`` / ``get_recorder()``
    The ambient recorder: instrumentation calls ``event()``, ``count()``
    and ``span()`` unconditionally, and they do nothing (one list read)
    when no recorder is active.

``span(name)``
    A timed region whose ``elapsed`` is always measured (two
    ``perf_counter`` calls), so ``run_federated`` uses it as its one
    wall-clock source with or without a recorder.  A span does not
    synchronise with the device: the caller does where the wall must
    cover device work (``run_federated``'s round and fused-chunk spans).
    While a torch profiler is running, with or without a recorder, the
    region is also a ``torch.profiler.record_function`` range, so the
    profiler's timeline shows every span on the clock of its device
    events; with no profiler running a span costs one check more.

The log keeps the reference's schema: the same span events and
counters.  It records the reference's spans (``LOGGED``); every other
span reaches a running profiler's timeline only, so a new span needs no
edit here.

Host-only code: no tensor is touched here, and torch is not imported
(a profiler can only run once something else has loaded it).
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any, Dict, Iterable, List, Optional

# Version of the events.jsonl format, written into every log's leading
# ``meta`` event and checked by the report reader: the reference's.
EVENT_SCHEMA = 1

EMITTER = f"repro_torch.obs/{EVENT_SCHEMA}"

# The spans the reference's ``events.jsonl`` has, the only ones the
# recorder logs: the log's span events and counters stay the reference's.
LOGGED = frozenset({"round", "fused_chunk", "encode", "eval"})


class Span:
    """One timed region.  ``elapsed`` is valid after the block exits."""

    __slots__ = ("name", "attrs", "t0", "elapsed")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.t0 = time.perf_counter()
        self.elapsed = 0.0

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self.t0
        return self.elapsed


class Recorder:
    """Append-only run event log with span and counter bookkeeping.

    ``path`` (optional) is where ``write()`` — and ``recording()`` on
    exit — dumps the JSONL stream.  Counters accumulate totals (events,
    spans, rejections by reason) that ``run_federated`` folds into
    ``RunResult.telemetry`` at the end of a run.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[str, int] = {"events": 0, "spans": 0,
                                         "host_offloads": 0}
        self._t0 = time.perf_counter()
        self.events.append({"ev": "meta", "ts": 0.0,
                            "schema": EVENT_SCHEMA, "emitter": EMITTER})

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def event(self, kind: str, **fields) -> Dict[str, Any]:
        e = {"ev": kind, "ts": round(self._now(), 6), **fields}
        self.events.append(e)
        self.counters["events"] += 1
        return e

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sp = Span(name, attrs)
        self.counters["spans"] += 1
        try:
            yield sp
        finally:
            sp.stop()
            self.event("span", name=name, dur=round(sp.elapsed, 6), **attrs)

    def write(self, path: Optional[str] = None) -> str:
        """Dump the log as JSONL; returns the path written."""
        out = path or self.path
        if not out:
            raise ValueError("no output path: pass one to write() or to "
                             "the Recorder/recording() constructor")
        with open(out, "w") as fh:
            for e in self.events:
                fh.write(json.dumps(e) + "\n")
        return out


class _NullSpan(Span):
    """Span without an attached recorder — timing only."""


# The ambient recorder stack: the federated loop is single-threaded host
# code and nesting is LIFO.
_STACK: List[Recorder] = []


def get_recorder() -> Optional[Recorder]:
    """The active recorder, or None when not recording."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def recording(path: Optional[str] = None,
              recorder: Optional[Recorder] = None):
    """Activate a recorder for the block; write JSONL on exit if it has a
    path.  Yields the recorder."""
    rec = recorder if recorder is not None else Recorder(path)
    if path is not None and rec.path is None:
        rec.path = path
    _STACK.append(rec)
    try:
        yield rec
    finally:
        _STACK.pop()
        if rec.path:
            rec.write()


def event(kind: str, **fields) -> None:
    """Record an event on the active recorder; no-op when not recording."""
    rec = get_recorder()
    if rec is not None:
        rec.event(kind, **fields)


def count(name: str, n: int = 1) -> None:
    """Bump a counter on the active recorder (no-op when inactive)."""
    rec = get_recorder()
    if rec is not None:
        rec.count(name, n)


def _profiler_running() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Timed region: always measures; records when a recorder is active
    and the reference's log has the span (``LOGGED``); is a
    ``record_function`` range while a torch profiler is running."""
    rf = None
    if _profiler_running():
        rf = sys.modules["torch"].profiler.record_function(name)
        rf.__enter__()
    rec = get_recorder() if name in LOGGED else None
    try:
        if rec is None:
            sp = _NullSpan(name, attrs)
            try:
                yield sp
            finally:
                sp.stop()
        else:
            with rec.span(name, **attrs) as sp:
                yield sp
    finally:
        if rf is not None:
            rf.__exit__(None, None, None)


def to_chrome_trace(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Render an event stream as a Chrome trace-event JSON object
    (Perfetto, chrome://tracing): spans become complete ('X') slices on
    one host track, everything else an instant ('i') event, timestamps in
    microseconds.  A ``span`` event carries its end time in ``ts``, so
    the slice starts at ``ts - dur``."""
    trace_events: List[Dict[str, Any]] = []
    for e in events:
        kind = e.get("ev")
        if kind == "meta":
            continue
        ts_us = float(e.get("ts", 0.0)) * 1e6
        args = {k: v for k, v in e.items() if k not in ("ev", "ts", "dur",
                                                        "name")}
        if kind == "span":
            dur_us = float(e.get("dur", 0.0)) * 1e6
            trace_events.append({
                "name": e.get("name", "span"), "ph": "X", "cat": "host",
                "ts": ts_us - dur_us, "dur": dur_us,
                "pid": 0, "tid": 0, "args": args})
        else:
            trace_events.append({
                "name": kind, "ph": "i", "s": "t", "cat": "event",
                "ts": ts_us, "pid": 0, "tid": 0, "args": args})
    return {"traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {"emitter": EMITTER}}
