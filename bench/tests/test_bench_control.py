"""Each cell's control (the plain reference in the nearest precision below
the configuration's, put in the program's place) comes out not correct:
at least one of the cell's numbers is over its limit on every seed.

At the cells' own sizes this needs the card (TF32 exists only there) and
takes minutes a cell; the LM control's fp8 also runs on the CPU at a toy
size."""
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_readings  # noqa: E402
from bench_tiny import BENCH, ROOT, tiny_bench  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = (2150000001, 2150000002, 2150000003)


def _limits(bench: Path, cell: str) -> dict:
    return json.loads((bench / "cells" / f"{cell}.json").read_text())[
        "limits"]


def _fails(readings: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in readings.items() if k in limits)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on the card")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_control_fails_at_the_cells_size(card, cell):
    limits = _limits(BENCH, cell)
    for seed in SEEDS:
        got = bench_readings.readings(cell, seed, ["control"])["control"]
        assert _fails(got, limits), (seed, got, limits)


def test_the_lm_control_fails_at_a_toy_size(tmp_path):
    bench = tiny_bench(tmp_path)
    limits = _limits(bench, "lm-tiny-step")
    got = bench_readings.readings("lm-tiny-step", SEEDS[0], ["control"],
                                  bench=bench, device="cpu")["control"]
    assert _fails(got, limits), (got, limits)
