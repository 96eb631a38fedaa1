"""privlint CLI — the port's client→server privacy-boundary lint gate.

    PYTHONPATH=src python -m repro_torch.analysis.privlint \
        src/repro_torch --baseline analysis/torch_privacy_baseline.json

Runs the interprocedural taint-flow analysis
(``repro_torch.analysis.taint`` with the policy in
``repro_torch.analysis.privrules``) over the call graph and reports
PL001–PL006 findings.  Exit status 0 when every finding is
suppressed in source (``# privlint: disable=PLxxx``) or recorded in the
committed baseline with a justification; 1 when new findings exist (the
CI gate); 2 on usage errors.  Pure ``ast`` — nothing under the scanned
paths is imported or executed, so the gate needs no device.

    --json-out FILE      machine-readable findings (new + baselined)
    --write-baseline     accept the current findings as the baseline
                         (existing justifications are preserved)
    --list-baseline      print the accepted findings and exit
    --rules PL001,PL004  run a subset of rules
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis import astgraph, privrules
from repro_torch.analysis.config import (DEFAULT_PATHS,
                                         DEFAULT_PRIVACY_BASELINE,
                                         SOURCE_ROOTS, expand_paths)
from repro_torch.analysis.report import (Baseline, Finding, assign_ordinals,
                                   decorator_regions, json_report,
                                   render_report, suppressed)


def run_paths(paths: Sequence[str],
              rules: Optional[Sequence[str]] = None,
              source_roots: Sequence[str] = SOURCE_ROOTS,
              ) -> Tuple[List[Finding], int]:
    """Lint ``paths``; returns (unsuppressed findings, files scanned)."""
    graph = astgraph.build_graph(expand_paths(paths), roots=source_roots)
    raw = privrules.run_privacy_rules(graph, rules=rules)
    findings: List[Finding] = []
    regions_by_path = {
        mod.path: (decorator_regions(mod.tree), mod.source_lines)
        for mod in graph.modules.values()}
    for f in raw:
        regions, source_lines = regions_by_path.get(f.path, (None, ()))
        if not suppressed(f, source_lines, regions):
            findings.append(f)
    return assign_ordinals(findings), len(graph.modules)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="privlint",
        description="interprocedural taint-flow analysis for the "
                    "client→server privacy boundary")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help=f"files/directories to lint "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--baseline", default=DEFAULT_PRIVACY_BASELINE,
                    help="committed accepted-findings file "
                         f"(default: {DEFAULT_PRIVACY_BASELINE}; "
                         f"pass '' for none)")
    ap.add_argument("--json-out", default=None,
                    help="write a machine-readable report to this file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings into the baseline")
    ap.add_argument("--list-baseline", action="store_true",
                    help="print the baseline entries and exit")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset (e.g. PL001,PL004)")
    args = ap.parse_args(argv)

    baseline_path = args.baseline or None
    try:
        baseline = Baseline.load(baseline_path)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"privlint: bad baseline: {e}", file=sys.stderr)
        return 2

    if args.list_baseline:
        for key, rec in sorted(baseline.entries.items()):
            just = rec.get("justification", "")
            print(f"{key}\n    {just}" if just else key)
        print(f"{len(baseline.entries)} baselined finding(s)")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        findings, files_scanned = run_paths(args.paths, rules=rules)
    except ValueError as e:
        print(f"privlint: {e}", file=sys.stderr)
        return 2

    new, accepted, stale = baseline.split(findings)

    if args.write_baseline:
        if baseline_path is None:
            print("privlint: --write-baseline needs --baseline",
                  file=sys.stderr)
            return 2
        baseline.write(baseline_path, findings)
        print(f"privlint: wrote {len(findings)} finding(s) to "
              f"{baseline_path} — fill in any TODO justifications")
        return 0

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(json_report(new, accepted, stale, files_scanned),
                      f, indent=1)
            f.write("\n")

    print(render_report(new, accepted, stale, baseline_path,
                        files_scanned, tool="privlint"))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
