"""The readings a cell's limits are set from, beside the benchmark's own
runs (which give the program's): the control (the plain reference in the
nearest precision below the configuration's, in the program's place) and
each planted fault (``faults.py``), against the fp32 reference, on the
cell's own sizes.

    python3 bench/tests/bench_readings.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed and mode.  Needs the card; the benchmark's
runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for _p in (str(BENCH), str(BENCH.parent / "src"), str(BENCH / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench_faults import faults_for, planted  # noqa: E402
from harness import registry  # noqa: E402

CONTROL = {"mlp_federated": "tf32", "lm_fedstep": "fp8"}


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def mlp_readings(cell, seed: int, modes, device: str = "cuda",
                 detail: bool = False, index: int = 1) -> dict:
    """The readings of the pool's experiment ``index``."""
    import time
    drv = cell.driver().Driver(cell, seed, device, _log)
    drv.setup(time.perf_counter())
    ref = drv.reference(index)
    out = {}
    for mode in modes:
        if mode == "control":
            got = drv.as_got(index, drv.reference(index, CONTROL[
                cell.spec["driver"]]))
        else:
            drv.next_index = index
            with planted(cell.spec["driver"], mode):
                got = drv.host(drv.experiment())
        out[mode] = drv.readings(got, ref, detail)
    return out


def lm_readings(cell, seed: int, modes, device: str = "cuda",
                detail: bool = False) -> dict:
    """Each fault's readings (and "sound": the program as it is), each
    from its own set-up of the first steps, and the control's, against
    one fp32 reference."""
    import time
    faults = [m for m in modes if m != "control"]
    out = {}
    drv = None
    for mode in faults or [None]:
        drv = cell.driver().Driver(cell, seed, device, _log)
        if mode in (None, "sound"):
            drv.setup(time.perf_counter())
        else:
            with planted(cell.spec["driver"], mode):
                drv.setup(time.perf_counter())
        got = {"losses": drv.losses, "grad1": drv.grad1,
               "change3": drv.change3}
        drv.release()
        if mode is not None:
            out[mode] = got
    ref = drv.reference()
    for mode in faults:
        out[mode] = drv.readings(out[mode], ref, detail)
    if "control" in modes:
        out["control"] = drv.readings(drv.reference(CONTROL[
            cell.spec["driver"]]), ref, detail)
    return out


def readings(cell_name: str, seed: int, modes=None, bench=BENCH,
             device: str = "cuda", detail: bool = False,
             index: int = 1) -> dict:
    cell = registry.find_cell(cell_name, bench)
    driver = cell.spec["driver"]
    if modes is None:
        # a state left unchanged reads 1 by the training measure: no run
        modes = [m for m in ("control",) + faults_for(cell)
                 if m != "unchanged"]
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
    if driver == "mlp_federated":
        return mlp_readings(cell, seed, modes, device, detail, index)
    return lm_readings(cell, seed, modes, device, detail)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="")
    ap.add_argument("--detail", type=int, default=0)
    ap.add_argument("--index", type=int, default=1,
                    help="the pool's experiment (the MLP cells)")
    a = ap.parse_args(argv)
    modes = [m for m in a.modes.split(",") if m] or None
    for seed in (int(s) for s in a.seeds.split(",")):
        r = readings(a.workload, seed, modes, detail=bool(a.detail),
                     index=a.index)
        for mode, values in r.items():
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "mode": mode, "readings": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
