"""``BENCHMARK.json`` and the files it names: every cell, configuration,
traffic mix, driver and per-layer metric loads by name, and the file
keeps to the benchmark's contract."""
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import registry  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    layers = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in layers and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
        moved = layers[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    c = registry.find_cell(cell)
    assert c.driver().Driver
    assert c.spec["limits"], "a cell's comparison has its limits"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(c.layer_reader(m["name"]).read)


def test_every_config_file_is_named_and_used():
    used = {w["config"] for w in SPEC["workloads"]}
    for cfg in SPEC["configs"]:
        assert cfg["name"] in used
        data = json.loads((ROOT / cfg["file"]).read_text())
        assert cfg["file"].startswith("bench/")
        assert all(k in data for k in cfg["reduced"])
    files = {c["file"] for c in SPEC["configs"]}
    assert len(files) == len(SPEC["configs"])


def test_a_missing_cell_is_refused():
    with pytest.raises(KeyError):
        registry.find_cell("no-such-cell")
