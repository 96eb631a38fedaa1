"""Which ops hold a dry-run record's peak.

Traces one combination of ``python -m repro_torch.launch.dryrun`` again
(the same ``dryrun_one``) with a tap on ``launch.roofline.StepCounter``:
each storage the counter holds is labelled with the aten op that made it
and the innermost line of ``repro_torch`` on the Python stack (the
kernels' plain versions and the counter itself skipped).  At the step's
peak on the meta device the live storages are grouped by (line, op) and
the largest groups printed, with their share of the peak.  Counts on
the CPU, not times; the tap is not part of the record.

    PYTHONPATH=src python benchmarks/torch_dryrun_peak_ops.py \
        --arch deepseek-v2-236b --shape prefill_32k --mesh single [--top 5]
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import traceback
import weakref
from pathlib import Path
from typing import Dict, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun, roofline  # noqa: E402

GB = 1e9
_SKIP = (os.path.join("launch", "roofline.py"),
         os.path.join("kernels", "build.py"))


def _site() -> str:
    """The innermost ``repro_torch`` source line on the stack."""
    for fr in reversed(traceback.extract_stack()):
        if "repro_torch" in fr.filename and \
                not fr.filename.endswith(_SKIP):
            path = fr.filename[fr.filename.rindex("repro_torch"):]
            return f"{path}:{fr.lineno}"
    return "?"


class PeakTap(roofline.StepCounter):
    """``StepCounter`` that also keeps the live meta bytes by (site, op)
    and a copy of them at each new peak."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._op = "?"
        self._label: Dict[int, Tuple[str, str]] = {}
        self.by_site: Dict[Tuple[str, str], int] = {}
        self.at_peak: Dict[Tuple[str, str], int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func._opname
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _hold(self, out, inputs) -> None:
        before = set(self._storages)
        self._labelling, self._grew = True, False
        super()._hold(out, inputs)
        for key in set(self._storages) - before:
            st = self._storages[key]()
            if st is None or st.device.type != "meta":
                continue
            label = (_site(), self._op)
            self._label[key] = label
            self.by_site[label] = self.by_site.get(label, 0) + st.nbytes()
            # the counter's weak reference frees it; follow the free too
            weakref.finalize(st, functools.partial(self._gone, key,
                                                   st.nbytes()))
        self._labelling = False
        if self._grew:
            self._snapshot()

    def _gone(self, key: int, n: int) -> None:
        label = self._label.pop(key, None)
        if label is not None:
            self.by_site[label] -= n

    def _snapshot(self) -> None:
        self.at_peak = {k: v for k, v in self.by_site.items() if v}

    def _update_peak(self, kind: str) -> None:
        grew = self.live_bytes[kind] > self.peak_bytes.get(kind, 0)
        super()._update_peak(kind)
        if kind == "meta" and grew:
            if getattr(self, "_labelling", False):
                self._grew = True        # snapshot once labelled
            else:
                self._snapshot()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    choices=list(dryrun.INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args(argv)
    taps = []

    def make(*a, **k):
        taps.append(PeakTap(*a, **k))
        return taps[-1]

    dryrun.StepCounter = make
    rec = dryrun.dryrun_one(args.arch, args.shape, args.mesh)
    if not rec["ok"]:
        raise SystemExit(rec.get("traceback", rec.get("error")))
    tap = taps[-1]
    peak = rec["memory"]["temp_size_in_bytes"]
    held = sum(tap.at_peak.values())
    print(f"{args.arch} {args.shape} {args.mesh}: peak "
          f"{rec['peak_bytes_per_dev'] / GB:.2f} GB a device, temp "
          f"{peak / GB:.2f} GB; held at the peak by the tap {held / GB:.2f}"
          f" GB")
    rows = sorted(tap.at_peak.items(), key=lambda kv: -kv[1])
    for (site, op), n in rows[:args.top]:
        print(f"  {n / GB:9.3f} GB {100 * n / max(peak, 1):5.1f}%  {op:24s} "
              f"{site}")


if __name__ == "__main__":
    main()
