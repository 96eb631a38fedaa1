"""The program's spans in a traced window.

``repro_torch.obs.trace.span`` opens a ``torch.profiler.record_function``
range whenever a profiler is running, so a traced window's host events
(``Window.host``) hold the program's spans on the clock of its device
events.  Here: those spans by name, each clipped to the window; a span's
self time (its clipped length less the union of the program spans nested
in it); and the window's idle gaps attributed by the rule of
``Window.breakdown``, to the innermost span that covers a gap's middle.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# the fused loop's spans (``core/scbf._run_fused``, ``run_federated``'s
# records, ``fed/engine.BatchedEngine``, ``comm/wire._encode_slots``)
PROGRAM_SPANS = ("fused_chunk", "plan", "replay", "encode", "encode.wait",
                 "record", "eval")

Interval = Tuple[str, float, float]


def program(window) -> List[Interval]:
    """The program's spans that overlap the window, unclipped, in order
    of their start."""
    return sorted((h for h in window.host if h[0] in PROGRAM_SPANS),
                  key=lambda h: (h[1], -h[2]))


def _clip(window, a: float, b: float) -> float:
    return max(0.0, min(b, window.end_us) - max(a, window.start_us))


def _union_us(window, spans: List[Interval]) -> float:
    at, total = window.start_us, 0.0
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        a, b = max(a, at), min(b, window.end_us)
        if b > a:
            total += b - a
            at = b
    return total


def _nested(spans: List[Interval], i: int) -> List[Interval]:
    """The spans inside span ``i`` (an equal interval counts as nested
    when it starts later in ``spans``' order)."""
    _, a, b = spans[i]
    return [s for j, s in enumerate(spans) if j != i and a <= s[1]
            and s[2] <= b and (s[2] - s[1] < b - a or j > i)]


def time_us(window, name: str, self_time: bool = False) -> Optional[float]:
    """Microseconds inside the window under the spans ``name``, less the
    spans nested in them with ``self_time``; None when the window holds
    no such span."""
    spans = program(window)
    total, found = 0.0, False
    for i, (n, a, b) in enumerate(spans):
        if n != name:
            continue
        found = True
        total += _clip(window, a, b)
        if self_time:
            total -= _union_us(window, _nested(spans, i))
    return total if found else None


def per_loop_ms(ctx, name: str, self_time: bool = False) -> Optional[float]:
    """``time_us`` a loop of the traced window, in ms."""
    us = time_us(ctx["window"], name, self_time)
    return None if us is None else us / 1e3 / ctx["loops"]


def idle_by_span(window) -> Dict[Optional[str], float]:
    """Idle seconds of the window by the innermost program span that
    covers each gap's middle (None: no span covers it)."""
    spans = sorted(program(window), key=lambda s: s[2] - s[1])
    out: Dict[Optional[str], float] = {}
    for a, b in window.gaps():
        mid = (a + b) / 2
        name = next((n for n, sa, sb in spans if sa <= mid <= sb), None)
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def idle_unspanned(window) -> float:
    """The share of the window's idle time (%) whose gaps lie, by their
    middle, under none of the program's spans."""
    idle = idle_by_span(window)
    total = sum(idle.values())
    return 100.0 * idle.get(None, 0.0) / total if total else 0.0
