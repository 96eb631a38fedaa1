"""``bench_readings.py`` for the ``dsv2_fedstep`` cells: importing this
module registers the driver with that tool, its control (the plain
reference with every product's operands in fp8, the nearest precision
below the configuration's bf16) and its planted faults
(``dsv2_faults.py``); the readings are then ``bench_readings``' own, each
against one fp32 reference on the cell's own sizes.

    python3 bench/tests/dsv2_readings.py --workload dsv2-fedstep-s256 --seeds 1,2,3 [--modes sound,control,...]

prints one JSON line a seed and mode.  Needs the card; the benchmark's
runs never run it.  ``conftest.py`` imports it for the tests here, so
``test_bench_control.py`` reads these cells' controls too.
"""
from __future__ import annotations

import sys
from pathlib import Path

_HERE = str(Path(__file__).resolve().parent)
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)

import bench_readings  # noqa: E402
import dsv2_faults  # noqa: E402

DRIVER = "dsv2_fedstep"


def _register() -> None:
    if bench_readings.CONTROL.get(DRIVER) == "fp8":
        return
    faults_for, planted = bench_readings.faults_for, bench_readings.planted

    def dsv2_faults_for(cell) -> tuple:
        if cell.spec["driver"] == DRIVER:
            return dsv2_faults.FAULTS
        return faults_for(cell)

    def dsv2_planted(driver: str, fault: str):
        if driver == DRIVER:
            return dsv2_faults.planted(fault)
        return planted(driver, fault)

    bench_readings.CONTROL[DRIVER] = "fp8"
    bench_readings.faults_for = dsv2_faults_for
    bench_readings.planted = dsv2_planted


_register()

if __name__ == "__main__":
    sys.exit(bench_readings.main())
