"""tracelint CLI — the port's capture/host-sync/rebuild lint gate.

    PYTHONPATH=src python -m repro_torch.analysis.tracelint \
        src/repro_torch --baseline analysis/torch_baseline.json

Exit status 0 when every finding is either suppressed in source
(``# tracelint: disable=TLxxx``) or recorded in the committed baseline;
1 when new findings exist (the CI gate); 2 on usage errors.  The
analysis is pure ``ast`` — nothing under the scanned paths is imported
or executed, so the lint job needs no device and runs in seconds.

    --json-out FILE      machine-readable findings (new + baselined)
    --write-baseline     accept the current findings as the baseline
                         (existing justifications are preserved)
    --list-baseline      print the accepted findings and exit
    --rules TL001,TL004  run a subset of rules
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis import astgraph
from repro_torch.analysis.config import (DEFAULT_BASELINE, DEFAULT_PATHS,
                                         LintConfig, SOURCE_ROOTS,
                                         expand_paths)
from repro_torch.analysis.report import (Baseline, Finding,
                                         assign_ordinals,
                                         decorator_regions, json_report,
                                         render_report, suppressed)


def run_paths(paths: Sequence[str],
              rules: Optional[Sequence[str]] = None,
              source_roots: Sequence[str] = SOURCE_ROOTS,
              ) -> Tuple[List[Finding], int]:
    """Lint ``paths``; returns (unsuppressed findings, files scanned)."""
    cfg = LintConfig(paths=expand_paths(paths),
                     rules=set(rules) if rules else set(
                         LintConfig().rules))
    graph = astgraph.build_graph(cfg.paths, roots=source_roots)
    findings: List[Finding] = []
    for mod in graph.modules.values():
        regions = decorator_regions(mod.tree)
        for code, rule in cfg.selected_rules().items():
            for f in rule(mod, graph):
                if not suppressed(f, mod.source_lines, regions):
                    findings.append(f)
    return assign_ordinals(findings), len(graph.modules)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tracelint",
        description="CUDA-graph-aware static analysis for the "
                    "re-capture/host-sync/rebuild bug class")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help=f"files/directories to lint "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="committed accepted-findings file "
                         f"(default: {DEFAULT_BASELINE}; pass '' for none)")
    ap.add_argument("--json-out", default=None,
                    help="write a machine-readable report to this file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings into the baseline")
    ap.add_argument("--list-baseline", action="store_true",
                    help="print the baseline entries and exit")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset (e.g. TL001,TL004)")
    args = ap.parse_args(argv)

    baseline_path = args.baseline or None
    try:
        baseline = Baseline.load(baseline_path)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"tracelint: bad baseline: {e}", file=sys.stderr)
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
        print(f"tracelint: {e}", file=sys.stderr)
        return 2

    new, accepted, stale = baseline.split(findings)

    if args.write_baseline:
        if baseline_path is None:
            print("tracelint: --write-baseline needs --baseline",
                  file=sys.stderr)
            return 2
        baseline.write(baseline_path, findings)
        print(f"tracelint: wrote {len(findings)} finding(s) to "
              f"{baseline_path} — fill in any TODO justifications")
        return 0

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(json_report(new, accepted, stale, files_scanned),
                      f, indent=1)
            f.write("\n")

    print(render_report(new, accepted, stale, baseline_path,
                        files_scanned))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
