"""A traced window: ``torch.profiler`` over a stretch of steady work, read
into device intervals, busy and idle time, time by kernel name, and the
idle gaps by what the host was doing.

The profiler's device events and its host events share one clock, so the
window is the host interval of the ``bench.window`` annotation and every
device interval is clipped to it.  A window opened right after heavy
device work can lose its first device events; so the window opens with a
burst of the cell's own kernels (``Tracer.start``), and ``robust_window``
checks the kernel events it finds against the launches the work made and
traces the work again once when events are missing.  A CUDA graph's
capture is never traced (a capture under the profiler has hung the card):
a window opens after it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "bench.window"

# a substring of each hand-written kernel's name in a trace, by counter
KERNEL_EVENTS = {"channel_norm": "channel_norms_kernel",
                 "select_mask": "select_mask_kernel",
                 "select_compact_count": "compact_count_kernel",
                 "select_compact_scatter": "compact_scatter_kernel",
                 "apoz": "apoz_leaves_kernel"}

# cuBLAS and CUTLASS matrix products, by a substring of the kernel name
GEMM_TAGS = ("gemm", "gemv", "cutlass", "xmma", "Kernel2", "splitKreduce",
             "dot_kernel")


@dataclass
class Window:
    """What one traced window holds: ``ops`` (name, start us, end us) of
    every device operation inside it, ``host`` (name, start us, end us)
    of the host operations, the window's bounds (us) and its host wall."""

    ops: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    start_us: float
    end_us: float
    info: Dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """{operation name: (count, device us)}."""
        out: Dict[str, Tuple[int, float]] = {}
        for name, a, b in self.ops:
            n, us = out.get(name, (0, 0.0))
            out[name] = (n + 1, us + (b - a))
        return out

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of the
        intervals (overlapping operations counted once)."""
        return sum(b - a for a, b in _union(self.ops)) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals (us) between the window's bounds."""
        out, at = [], self.start_us
        for a, b in _union(self.ops):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.end_us > at:
            out.append((at, self.end_us))
        return out

    def time_of(self, tag: str) -> Tuple[int, float]:
        """(count, device seconds) of the operations whose name holds
        ``tag``."""
        n = us = 0
        for name, a, b in self.ops:
            if tag in name:
                n += 1
                us += b - a
        return n, us / 1e6

    def kernel_count(self, counter: str) -> int:
        return self.time_of(KERNEL_EVENTS[counter])[0]

    def gemm_s(self) -> float:
        us = sum(b - a for name, a, b in self.ops
                 if any(t in name for t in GEMM_TAGS)
                 and "Memcpy" not in name)
        return us / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The contract's ``breakdown``: the device operations that took
        most time, and the longest idle gaps summed by the host operation
        that covered each gap's middle (the innermost one)."""
        ops = sorted(((n, us / 1e6) for n, (_, us) in self.by_name().items()),
                     key=lambda kv: -kv[1])[:top]
        host = sorted(self.host, key=lambda h: h[2] - h[1])
        idle: Dict[str, float] = {}
        for a, b in self.gaps():
            mid = (a + b) / 2
            name = next((h[0] for h in host if h[1] <= mid <= h[2]
                         and h[0] != WINDOW), "host: none")
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def _union(ops) -> List[Tuple[float, float]]:
    spans = sorted((a, b) for _, a, b in ops)
    out: List[List[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Tracer:
    """A profiler window opened and closed by hand (``start`` / ``stop``),
    so it can open inside the program's control flow: after a capture,
    which is never traced.  The window is the ``bench.window`` annotation,
    entered synchronised after the ``burst``, left synchronised."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = self.rf = None

    def start(self, burst: Optional[Callable[[], None]] = None) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        torch = self.torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        if burst is not None:
            burst()
        torch.cuda.synchronize()
        self.rf = record_function(WINDOW)
        self.rf.__enter__()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop(self) -> Window:
        self.torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        prof, self.prof, self.rf = self.prof, None, None
        return _read(prof)


def _read(prof) -> Window:
    from torch.autograd import DeviceType
    ops, host, bounds = [], [], None
    for e in prof.events():
        a = float(e.time_range.start)
        b = float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("ProfilerStep") or e.name == WINDOW:
                continue
            ops.append((e.name, a, b))
        else:
            if e.name == WINDOW:
                bounds = (a, b)
            host.append((e.name, a, b))
    if bounds is None:
        raise RuntimeError("the traced window's annotation is missing")
    lo, hi = bounds
    ops = [(n, max(a, lo), min(b, hi)) for n, a, b in ops if b > lo and a < hi]
    host = [h for h in host if h[2] > lo and h[1] < hi]
    return Window(ops=ops, host=host, start_us=lo, end_us=hi)


def launch_counts() -> Dict[str, int]:
    """The port's kernel wrappers' launch counters (graph replays apart)."""
    from repro_torch.kernels import apoz as az
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm
    return {"channel_norm": cn.launches, "select_mask": sm.mask_launches,
            "select_compact_count": sm.compact_count_launches,
            "select_compact_scatter": sm.compact_scatter_launches,
            "apoz": az.launches}


def robust_window(attempt: Callable[[], Tuple[Window, Dict[str, int]]],
                  log=print) -> Window:
    """A traced window whose hand-written kernel events are all there.
    ``attempt`` traces the window's work and returns the window and the
    kernel launches the work made (wrapper counts plus graph replays, by
    ``KERNEL_EVENTS`` counter); a window that holds fewer events than
    that is traced again once, and a second short one is marked
    incomplete in its ``info`` (its kernel rooflines are left out)."""
    for n in (1, 2):
        w, expected = attempt()
        found = {k: w.kernel_count(k) for k in expected}
        w.info = {"expected_kernels": dict(expected),
                  "found_kernels": found, "attempt": n,
                  "complete": found == expected}
        if w.info["complete"]:
            return w
        log(f"traced window {n}: kernel events {found}, launches "
            f"{expected}; " + ("tracing it again" if n == 1
                               else "kernel rooflines left out"))
    return w
