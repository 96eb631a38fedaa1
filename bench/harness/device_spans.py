"""The program's spans on the card: the device-side extents that the
profiler gives each ``record_function`` range (its user annotations on
the device, ``is_user_annotation``, which ``trace._read`` leaves out of a
window's device operations), and the device's busy time under them.

``SpanTracer`` is ``trace.Tracer`` whose window also carries, as
``window.device_spans``, those extents of the names asked for, clipped
to the window.  A span's device time is the union of the window's
device operations inside the union of its extents: busy time, so the
idle gaps inside an extent count nothing and nested or overlapping
extents of one name count once.

Its window is a ``SpanWindow``: ``trace.Window`` with the same
``breakdown``, reached by a sweep instead of a scan of every host event
for every idle gap (a step of the LM cells makes ≈ 6,700 device and
39,000 host events, where the scan takes a minute).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from harness.trace import WINDOW, Tracer, Window, _union

Interval = Tuple[str, float, float]


def read_device_spans(prof, window, names: Iterable[str]) -> List[Interval]:
    """The device-side annotations of ``names`` in ``prof``'s events,
    clipped to the window, in order of their start."""
    from torch.autograd import DeviceType
    names = set(names)
    lo, hi = window.start_us, window.end_us
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name not in names or \
                not getattr(e, "is_user_annotation", False):
            continue
        a, b = float(e.time_range.start), float(e.time_range.end)
        if b > lo and a < hi:
            out.append((e.name, max(a, lo), min(b, hi)))
    return sorted(out, key=lambda s: s[1])


class SpanWindow(Window):
    """A ``Window`` whose ``breakdown`` gives ``Window.breakdown``'s
    result: each idle gap goes to the shortest host operation (the
    first of equal ones in ``host``'s order) that covers its middle.
    Here the host operations, shortest first, each take the gaps' middles
    they cover that no shorter one took."""

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, us / 1e6) for n, (_, us) in self.by_name().items()),
                     key=lambda kv: -kv[1])[:top]
        gaps = self.gaps()
        mids = [(a + b) / 2 for a, b in gaps]
        owner: List[Optional[str]] = [None] * len(gaps)
        after = list(range(len(gaps) + 1))   # the next middle not taken

        def free(i: int) -> int:
            while after[i] != i:
                after[i] = after[after[i]]
                i = after[i]
            return i

        for name, a, b in sorted(self.host, key=lambda h: h[2] - h[1]):
            if name == WINDOW:
                continue
            i, end = free(bisect.bisect_left(mids, a)), \
                bisect.bisect_right(mids, b)
            while i < end:
                owner[i] = name
                after[i] = i + 1
                i = free(i + 1)
        idle: Dict[str, float] = {}
        for (a, b), name in zip(gaps, owner):
            name = "host: none" if name is None else name
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
        worst = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in worst]}


class SpanTracer(Tracer):
    """A ``Tracer`` that keeps the device-side extents of ``names``, in a
    ``SpanWindow``."""

    def __init__(self, torch, names: Iterable[str]):
        super().__init__(torch)
        self.names = tuple(names)

    def stop(self) -> SpanWindow:
        prof = self.prof
        w = super().stop()
        w = SpanWindow(**{f.name: getattr(w, f.name)
                          for f in dataclasses.fields(w)})
        w.device_spans = read_device_spans(prof, w, self.names)
        return w


def busy_us(window, name: str) -> Optional[float]:
    """Device-busy microseconds under the spans ``name``; None when the
    window carries no device extent of that name."""
    spans = [(a, b) for n, a, b in getattr(window, "device_spans", None)
             or () if n == name]
    if not spans:
        return None
    cover = _union([("", a, b) for a, b in spans])
    total = 0.0
    for a, b in _union(window.ops):
        for c, d in cover:
            total += max(0.0, min(b, d) - max(a, c))
    return total


def per_step_ms(ctx, name: str) -> Optional[float]:
    """``busy_us`` a traced step, in ms."""
    w = ctx.get("window")
    us = None if w is None else busy_us(w, name)
    return None if us is None else us / 1e3 / ctx["steps"]


def idle_unspanned(window) -> Optional[float]:
    """The share of the window's idle time (%) whose gaps lie, by their
    middle, under none of the device extents the window carries; None
    when it carries none."""
    spans = getattr(window, "device_spans", None)
    if not spans:
        return None
    cover = _union(spans)
    starts = [a for a, _ in cover]
    total = unspanned = 0.0
    for a, b in window.gaps():
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        total += b - a
        if i < 0 or mid > cover[i][1]:
            unspanned += b - a
    return 100.0 * unspanned / total if total else 0.0
