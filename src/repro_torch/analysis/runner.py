"""Merged analysis runner for the port — all three linters, one report,
one exit code.

    PYTHONPATH=src python -m repro_torch.analysis          # all linters
    PYTHONPATH=src python -m repro_torch.analysis --trace  # tracelint only
    PYTHONPATH=src python -m repro_torch.analysis --privacy  # privlint only
    PYTHONPATH=src python -m repro_torch.analysis --shape  # shapelint only
    PYTHONPATH=src python -m repro_torch.analysis --privacy --json-out
    PYTHONPATH=src python -m repro_torch.analysis --json-out report.json

The paths default to ``src/repro_torch`` and ``benchmarks/torch_*.py``.
Each tool keeps its own committed baseline (tracelint →
``analysis/torch_baseline.json``, privlint →
``analysis/torch_privacy_baseline.json``, shapelint →
``analysis/torch_shape_baseline.json``) and its own suppression comment
prefix; the runner merges their reports and exits 1 when ANY tool has
new findings, 2 on a bad baseline or rule.  Pure ``ast`` end to end: no
device, no imports of scanned code.  (``python -m repro.analysis src
benchmarks examples``, the reference's runner, still gates the whole
tree, the port included.)
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis import privlint, shapelint, tracelint
from repro_torch.analysis.config import (DEFAULT_BASELINE, DEFAULT_PATHS,
                                         DEFAULT_PRIVACY_BASELINE,
                                         DEFAULT_SHAPE_BASELINE)
from repro_torch.analysis.report import (Baseline, json_report, render_report)

_TOOLS = {
    "tracelint": (tracelint.run_paths, DEFAULT_BASELINE),
    "privlint": (privlint.run_paths, DEFAULT_PRIVACY_BASELINE),
    "shapelint": (shapelint.run_paths, DEFAULT_SHAPE_BASELINE),
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="run the repo's static analyses (tracelint + "
                    "privlint + shapelint) with one merged report")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help=f"files/directories to lint "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--trace", action="store_true",
                    help="run tracelint (TL rules) only")
    ap.add_argument("--privacy", action="store_true",
                    help="run privlint (PL rules) only")
    ap.add_argument("--shape", action="store_true",
                    help="run shapelint (SL rules) only")
    ap.add_argument("--trace-baseline", default=DEFAULT_BASELINE,
                    help=f"tracelint baseline "
                         f"(default: {DEFAULT_BASELINE}; '' for none)")
    ap.add_argument("--privacy-baseline",
                    default=DEFAULT_PRIVACY_BASELINE,
                    help=f"privlint baseline (default: "
                         f"{DEFAULT_PRIVACY_BASELINE}; '' for none)")
    ap.add_argument("--shape-baseline",
                    default=DEFAULT_SHAPE_BASELINE,
                    help=f"shapelint baseline (default: "
                         f"{DEFAULT_SHAPE_BASELINE}; '' for none)")
    ap.add_argument("--json-out", nargs="?", const="-", default=None,
                    metavar="FILE",
                    help="write the merged machine-readable report to "
                         "FILE ('-' or no value: stdout)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules (e.g. "
                         "TL002,PL001); each tool runs its own codes")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept each tool's current findings into its "
                         "baseline (justifications kept)")
    args = ap.parse_args(argv)
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        prefixes = {"TL": "tracelint", "PL": "privlint", "SL": "shapelint"}
        unknown = [r for r in rules if r[:2] not in prefixes]
        if unknown:
            print(f"unknown rule(s) {unknown}", file=sys.stderr)
            return 2

    selected = [name for name, flag in
                (("tracelint", args.trace), ("privlint", args.privacy),
                 ("shapelint", args.shape))
                if flag] or list(_TOOLS)
    if rules is not None:
        selected = [name for name in selected
                    if any(prefixes[r[:2]] == name for r in rules)]
    baselines = {"tracelint": args.trace_baseline or None,
                 "privlint": args.privacy_baseline or None,
                 "shapelint": args.shape_baseline or None}

    merged = {"version": 1, "tools": {}}
    reports: List[str] = []
    exit_code = 0
    for name in selected:
        run, _default = _TOOLS[name]
        try:
            baseline = Baseline.load(baselines[name])
        except (ValueError, json.JSONDecodeError) as e:
            print(f"{name}: bad baseline: {e}", file=sys.stderr)
            return 2
        own = None if rules is None else \
            [r for r in rules if prefixes[r[:2]] == name]
        try:
            findings, files_scanned = run(args.paths, rules=own)
        except ValueError as e:
            print(f"{name}: {e}", file=sys.stderr)
            return 2
        if args.write_baseline:
            if baselines[name] is None:
                print(f"{name}: --write-baseline needs a baseline path",
                      file=sys.stderr)
                return 2
            baseline.write(baselines[name], findings)
            reports.append(f"{name}: wrote {len(findings)} finding(s) to "
                           f"{baselines[name]}")
            continue
        new, accepted, stale = baseline.split(findings)
        merged["tools"][name] = json_report(new, accepted, stale,
                                            files_scanned)
        reports.append(render_report(new, accepted, stale,
                                     baselines[name], files_scanned,
                                     tool=name))
        if new:
            exit_code = 1

    if args.json_out is not None:
        if args.json_out == "-":
            json.dump(merged, sys.stdout, indent=1)
            sys.stdout.write("\n")
        else:
            with open(args.json_out, "w", encoding="utf-8") as f:
                json.dump(merged, f, indent=1)
                f.write("\n")

    print("\n".join(reports))
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
