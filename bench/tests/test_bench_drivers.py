"""Each driver runs a tiny cell end to end on the CPU (cells added by
files and entries alone), its plain reference agrees with the port, and
a run with the timed path broken underneath comes out not correct."""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_faults import faults_for, planted  # noqa: E402
from bench_tiny import BENCH, ROOT, TINY, run_cell, tiny_bench  # noqa: E402


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_tiny_cell_runs_and_is_correct(bench, cell):
    out = run_cell(bench, cell)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    for name, c in out["checks"].items():
        # the plain reference and the port agree at a toy size to
        # rounding, far inside the cell's limits
        assert math.isfinite(c["value"]) and c["value"] < 1e-5, name


def _faulted():
    """(tiny cell, fault) for every fault its driver and method can have."""
    from types import SimpleNamespace
    out = []
    for cell in sorted(TINY):
        like = SimpleNamespace(spec={"driver": TINY[cell][2]}, traffic={
            "method": "fedavg" if "fedavg" in cell else "scbf"})
        out += [(cell, f) for f in faults_for(like)]
    return out


@pytest.mark.parametrize("cell,fault", _faulted())
def test_a_broken_timed_path_is_not_correct(bench, cell, fault):
    with planted(TINY[cell][2], fault):
        out = run_cell(bench, cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    import run
    rc = run.main(["--workload", "mlp-scbf-fused", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_the_harness_alone_is_no_benchmark(tmp_path):
    """In a directory of ``BENCHMARK.json`` and ``bench/`` alone (no
    program), a run fails and prints no result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "mlp-scbf-fused", "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
