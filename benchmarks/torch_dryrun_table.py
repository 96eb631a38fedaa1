"""The port's dry-run records as one table (counts, read from
``experiments/dryrun_torch/*.json``, which ``python -m
repro_torch.launch.dryrun`` writes on the CPU): for each (arch × shape ×
mesh), the per-device state, the most a step holds above it (temp), the
peak and whether it fits one H100's 80 GB; then, for each train shape
on (2, 16, 16), the bytes a rank sends across pods with the dense and
the compressed exchange and their ratio.  Counts, not times.

    PYTHONPATH=src python benchmarks/torch_dryrun_table.py [--dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.config import HARDWARE  # noqa: E402

GB = 1e9


def load(directory: str) -> dict:
    """Records by (arch, shape, mesh, tag)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        out[(rec["arch"], rec["shape"], rec["mesh"], rec["tag"])] = rec
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("arch,shape,mesh,tag,ok,state_gb,temp_gb,peak_gb,fits_80gb")
    for (arch, shape, mesh, tag), r in recs.items():
        if not r["ok"]:
            print(f"{arch},{shape},{mesh},{tag},False,,,,")
            continue
        mem = r["memory"]
        print(f"{arch},{shape},{mesh},{tag},True,"
              f"{mem['argument_size_in_bytes'] / GB:.3f},"
              f"{mem['temp_size_in_bytes'] / GB:.3f},"
              f"{r['peak_bytes_per_dev'] / GB:.3f},"
              f"{r['peak_bytes_per_dev'] <= HARDWARE.hbm_bytes}")
    print()
    print("arch,shape,dense_cross_pod_bytes,compressed_cross_pod_bytes,"
          "ratio")
    for (arch, shape, mesh, tag), r in recs.items():
        dense = recs.get((arch, shape, mesh, ""))
        if tag != "compressed" or not (r["ok"] and dense and dense["ok"]):
            continue
        d = dense["collectives"]["cross_pod_bytes"]
        c = r["collectives"]["cross_pod_bytes"]
        print(f"{arch},{shape},{d},{c},{c / d:.4f}")


if __name__ == "__main__":
    main()
