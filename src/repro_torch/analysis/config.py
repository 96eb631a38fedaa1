"""tracelint configuration for the port: rule registry and defaults.

Importable without a device: the linters run in a bare CI job (and in
pre-commit hooks) and import nothing they scan.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Set

from repro_torch.analysis.rules import ALL_RULES

DEFAULT_PATHS = ("src/repro_torch", "benchmarks/torch_*.py")
DEFAULT_BASELINE = "analysis/torch_baseline.json"
DEFAULT_PRIVACY_BASELINE = "analysis/torch_privacy_baseline.json"
DEFAULT_SHAPE_BASELINE = "analysis/torch_shape_baseline.json"

# package roots stripped when deriving dotted module names
SOURCE_ROOTS = ("src",)


def expand_paths(paths: Sequence[str]) -> tuple:
    """``paths`` with shell-style patterns (``benchmarks/torch_*.py``)
    expanded, in order; a pattern that matches nothing drops out."""
    import glob
    out = []
    for p in paths:
        out += sorted(glob.glob(p)) if glob.has_magic(p) else [p]
    return tuple(out)


@dataclass
class LintConfig:
    paths: Sequence[str] = DEFAULT_PATHS
    baseline: str = DEFAULT_BASELINE
    rules: Set[str] = field(default_factory=lambda: set(ALL_RULES))

    def selected_rules(self):
        unknown = self.rules - set(ALL_RULES)
        if unknown:
            raise ValueError(
                f"unknown rule(s) {sorted(unknown)}; "
                f"known: {sorted(ALL_RULES)}")
        return {code: ALL_RULES[code] for code in sorted(self.rules)}
