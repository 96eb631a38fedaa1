"""Two designs of the channel-norm kernel's cross-block reduction, timed
on the main path's client pass (2917x256 + 256x64 + 64x1 fp32) on one
CUDA card:

- ``tickets``: the port's kernel (``src/repro_torch/kernels/csrc/
  channel_norm.cu``): tiles spread over most of the SMs, the last tile of
  each strip to take its ticket adds the strip's partials;
- ``cluster16`` / ``cluster8``: ``benchmarks/cuda_channel_norm_cluster.cu``,
  one thread-block cluster of 16 (or 8) blocks a leaf, the column partials
  added through distributed shared memory.

    PYTHONPATH=src python benchmarks/cuda_channel_norm_designs.py

Both are held to the plain version (rtol 1e-5, atol 1e-6) first, then
timed in turns (a, b, c, c, b, a) by the profiler's device time and by
CUDA events (host launch path included).  Prints one JSON line with the
card's name and power limit.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(2917, 256), (256, 64), (64, 1)]
CLUSTER_SRC = ROOT / "benchmarks" / "cuda_channel_norm_cluster.cu"


def _cluster_lib(build, cl: int) -> ctypes.CDLL:
    out = build.BUILD_DIR / f"libcn_cluster{cl}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, f"-DCL={cl}",
                    "-o", str(out), str(CLUSTER_SRC)], check=True)
    lib = ctypes.CDLL(str(out))
    args, res = build.SIGNATURES["channel_norm"]["channel_norms_launch"]
    lib.channel_norms_launch.argtypes = args
    lib.channel_norms_launch.restype = res
    return lib


def _device_us(torch, fn, iters: int = 200) -> float:
    """Device microseconds a call in kernels, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / iters


def _event_us(torch, fn, iters: int = 500) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import channel_norm as cn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build.libraries()
    designs = {"tickets": libs["channel_norm"],
               "cluster16": _cluster_lib(build, 16),
               "cluster8": _cluster_lib(build, 8)}
    gen = torch.Generator().manual_seed(0)
    gs = [torch.randn(s, generator=gen).cuda() for s in SHAPES]
    want = [cn.channel_norms_plain(g) for g in gs]

    def run():
        return cn.channel_norms_leaves(gs)

    result = {name: {"device_us": 0.0, "event_us": 0.0} for name in designs}
    order = list(designs) + list(designs)[::-1]
    for name in order:
        libs["channel_norm"] = designs[name]
        for (row, col), (prow, pcol) in zip(run(), want):
            torch.testing.assert_close(row, prow, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(col, pcol, rtol=1e-5, atol=1e-6)
        result[name]["device_us"] += _device_us(torch, run) / 2
        result[name]["event_us"] += _event_us(torch, run) / 2
    libs["channel_norm"] = designs["tickets"]
    print(json.dumps({"bench": "channel_norm reduction designs",
                      "pass": "+".join(f"{m}x{n}" for m, n in SHAPES)
                      + " fp32", "card": card, "designs": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
