"""Finds the benchmark's parts by name.

Everything that belongs to one cell, configuration, traffic mix, driver or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` (at the root of the checkout) gives it:

    bench/cells/<cell>.json           the configuration, traffic and driver
    bench/configs/<config>.json       the sizes, as run, with their source
    bench/traffic/<traffic>.json      the mix's parameters
    bench/drivers/<driver>.py         the code that drives the program
    bench/layer_metrics/<metric>.py   one reader a per-layer metric

So a later change adds a cell, a configuration or a metric by adding a
file and an entry, and edits none of these modules.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str) -> ModuleType:
    """A Python file by path; its module name is made safe from the file
    name (metric names hold dots)."""
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    name = prefix + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    entry: dict              # the workload's entry in BENCHMARK.json
    spec: dict               # bench/cells/<name>.json
    config: dict             # bench/configs/<config>.json
    traffic: dict            # bench/traffic/<traffic>.json
    end_to_end: List[dict]   # the end-to-end metrics this cell reports
    per_layer: List[dict]    # the per-layer metrics this cell reports
    bench: Path

    def driver(self) -> ModuleType:
        return load_module(self.bench / "drivers" / f"{self.spec['driver']}.py",
                           "bench_driver")

    def layer_reader(self, metric: str) -> ModuleType:
        return load_module(self.bench / "layer_metrics" / f"{metric}.py",
                           "bench_metric")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark(bench: Optional[Path] = None) -> dict:
    bench = bench or BENCH
    return load_json(bench.parent / "BENCHMARK.json")


def find_cell(name: str, bench: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files."""
    bench = bench or BENCH
    spec_all = benchmark(bench)
    entries: Dict[str, dict] = {w["name"]: w for w in spec_all["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    spec = load_json(bench / "cells" / f"{name}.json")
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} {spec[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in spec_all["configs"]}[entry["config"]]
    config = load_json(bench.parent / cfg_entry["file"])
    traffic = load_json(bench / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, chips=int(entry["chips"]), entry=entry, spec=spec,
                config=config, traffic=traffic,
                end_to_end=[m for m in spec_all["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec_all["per_layer"]
                           if _applies(m, name)],
                bench=bench)
