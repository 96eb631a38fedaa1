"""Findings, suppressions, baselines, and rendering (a copy of
``repro.analysis.report``: the port's three linters share its keys,
suppression comments and baseline files).

A finding's **key** is line-number-free on purpose:

    <rule>:<file>:<symbol>:<ordinal>

(ordinal = n-th finding of that rule inside that symbol), so the
committed baseline survives unrelated edits that shift line numbers.
Suppression is per line: a ``# tracelint: disable=TL001`` (or
``# privlint: disable=PL001``, ``disable=TL001,TL002``, or a bare
``disable`` for all rules) comment on the flagged line or the line
directly above silences the finding at the source; for a finding inside
a decorated ``def``'s header (any decorator line through the ``def``
line) the comment may sit anywhere in that header or on the line above
it.  The baseline instead *records* a finding that stays visible in
``--list-baseline`` with a justification.  All three linters
(tracelint, privlint, and shapelint) share these semantics — the
rule-code filter is what scopes a comment to one tool.
"""
from __future__ import annotations

import ast
import json
import os
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

_SUPPRESS_RE = re.compile(
    r"#\s*(?:tracelint|privlint|shapelint):"
    r"\s*disable(?:=(?P<codes>[A-Z0-9,\s]+))?")

BASELINE_VERSION = 1


@dataclass
class Finding:
    rule: str                 # "TL001"
    path: str                 # repo-relative path as scanned
    line: int
    col: int
    message: str
    symbol: str = "<module>"  # enclosing function qualname
    ordinal: int = 0          # n-th (rule, path, symbol) finding

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}:{self.ordinal}"

    def as_dict(self) -> Dict:
        return {"key": self.key, "rule": self.rule, "file": self.path,
                "line": self.line, "col": self.col, "symbol": self.symbol,
                "message": self.message}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message} [in {self.symbol}]")


def assign_ordinals(findings: List[Finding]) -> List[Finding]:
    """Stable per-(rule, path, symbol) ordinals, in (line, col) order."""
    counts: Counter = Counter()
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        slot = (f.rule, f.path, f.symbol)
        f.ordinal = counts[slot]
        counts[slot] += 1
    return findings


def decorator_regions(tree: ast.AST) -> Dict[int, range]:
    """Lines inside a decorated def/class header → the whole header.

    A finding anchored to a decorator line (``@functools.lru_cache(...)``)
    used to require the disable comment on that exact line; mapping every
    header line (first decorator .. the ``def``/``class`` line) to the
    full header lets the comment sit anywhere in it, or on the line
    directly above the first decorator.
    """
    regions: Dict[int, range] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node.decorator_list:
            start = min(d.lineno for d in node.decorator_list)
            region = range(start - 1, node.lineno + 1)
            for ln in range(start, node.lineno + 1):
                regions[ln] = region
    return regions


def suppressed(finding: Finding, source_lines: Sequence[str],
               regions: Optional[Dict[int, range]] = None) -> bool:
    """True when a disable comment covers the finding's line."""
    lines = {finding.line, finding.line - 1}
    if regions and finding.line in regions:
        lines.update(regions[finding.line])
    for lineno in lines:
        if 1 <= lineno <= len(source_lines):
            m = _SUPPRESS_RE.search(source_lines[lineno - 1])
            if m:
                codes = m.group("codes")
                if codes is None:
                    return True
                if finding.rule in {c.strip()
                                    for c in codes.split(",") if c.strip()}:
                    return True
    return False


@dataclass
class Baseline:
    """The committed set of accepted findings
    (``analysis/torch_*baseline.json``)."""

    path: Optional[str] = None
    entries: Dict[str, Dict] = field(default_factory=dict)  # key -> record

    @classmethod
    def load(cls, path: Optional[str]) -> "Baseline":
        if path is None or not os.path.exists(path):
            return cls(path=path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if data.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"baseline {path}: unsupported version "
                f"{data.get('version')!r} (expected {BASELINE_VERSION})")
        return cls(path=path,
                   entries={e["key"]: e for e in data.get("findings", [])})

    def split(self, findings: Sequence[Finding]):
        """(new, accepted, stale-keys) for one run's findings."""
        new, accepted = [], []
        seen = set()
        for f in findings:
            if f.key in self.entries:
                accepted.append(f)
                seen.add(f.key)
            else:
                new.append(f)
        stale = [k for k in self.entries if k not in seen]
        return new, accepted, stale

    def write(self, path: str, findings: Sequence[Finding]) -> None:
        """Write ``findings`` as the new baseline, keeping any existing
        justifications for keys that persist."""
        records = []
        for f in sorted(findings, key=lambda f: f.key):
            rec = {"key": f.key, "rule": f.rule, "file": f.path,
                   "symbol": f.symbol, "message": f.message}
            old = self.entries.get(f.key)
            if old and old.get("justification"):
                rec["justification"] = old["justification"]
            else:
                rec["justification"] = "TODO: justify or fix"
            records.append(rec)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": BASELINE_VERSION, "findings": records},
                      f, indent=1)
            f.write("\n")


def render_report(new: Sequence[Finding], accepted: Sequence[Finding],
                  stale: Sequence[str], baseline_path: Optional[str],
                  files_scanned: int, tool: str = "tracelint") -> str:
    lines: List[str] = []
    for f in sorted(new, key=lambda f: (f.path, f.line, f.col)):
        lines.append(f.render())
    if new:
        lines.append("")
    lines.append(f"{tool}: {files_scanned} files, "
                 f"{len(new)} new finding(s), "
                 f"{len(accepted)} baselined, {len(stale)} stale "
                 f"baseline entr{'y' if len(stale) == 1 else 'ies'}")
    if new:
        lines.append(
            "  new findings fail the lint: fix them, suppress with "
            f"'# {tool}: disable=<rule>' where intended, or accept "
            "into the baseline with --write-baseline"
            + (f" ({baseline_path})" if baseline_path else ""))
    if stale:
        lines.append(
            "  stale entries no longer occur — refresh the baseline "
            "with --write-baseline to drop them")
    return "\n".join(lines)


def json_report(new: Sequence[Finding], accepted: Sequence[Finding],
                stale: Sequence[str], files_scanned: int) -> Dict:
    return {
        "version": BASELINE_VERSION,
        "files_scanned": files_scanned,
        "new": [f.as_dict() for f in sorted(
            new, key=lambda f: (f.path, f.line, f.col))],
        "baselined": [f.as_dict() for f in sorted(
            accepted, key=lambda f: (f.path, f.line, f.col))],
        "stale_baseline_keys": sorted(stale),
    }
