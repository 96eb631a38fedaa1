"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  The build runs at first use,
from the package's own sources, into ``build/repro_torch_kernels/`` at the
repository root; each library's file name carries a hash of its source
and flags, so an edited source is rebuilt and an unchanged one is reused.
All sources compile in parallel, one ``nvcc`` each.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("channel_norm", "select_mask", "select_compact", "apoz",
           "sum_sgd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of the exported launchers; every launcher returns the
# cudaError_t of its launch (0 = success)
SIGNATURES = {
    "channel_norm": {
        # rows (host int64 table of slot-stacked leaves), L, dtype,
        # workspace, workspace words, stream
        "channel_norms_launch": ([_VOID, _INT, _INT, _VOID, _LL, _VOID],
                                 _INT),
    },
    "select_mask": {
        # rows (host int64 table of slot-stacked leaves), L, dtype, counts,
        # stream
        "select_mask_launch": ([_VOID, _INT, _INT, _VOID, _VOID], _INT),
    },
    "select_compact": {
        # rows (host int64 table of slot-stacked leaves), L, dtype,
        # drop_zeros, tile_counts, offsets, work_len, stream
        "select_compact_count_launch": ([_VOID, _INT, _INT, _INT, _VOID,
                                         _VOID, _LL, _VOID], _INT),
        # rows, L, pairs (host int64 table of (leaf, slot) pairs), P, out,
        # dtype, drop_zeros, tile_counts, offsets, work_len, stream
        "select_compact_scatter_launch": ([_VOID, _INT, _VOID, _INT, _VOID,
                                           _INT, _INT, _VOID, _VOID, _LL,
                                           _VOID], _INT),
    },
    "apoz": {
        # rows (host int64 table), L, recip, stream
        "apoz_counts_launch": ([_VOID, _INT, ctypes.c_float, _VOID], _INT),
    },
    "sum_sgd": {
        # p, g (K slots), out, n, K, lr, dtype, stream
        "sum_sgd_launch": ([_VOID, _VOID, _VOID, _LL, _INT, ctypes.c_float,
                            _INT, _VOID], _INT),
    },
}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME); the port's "
                       "kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source, all in parallel; returns name → .so."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, todo[name])
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return paths


@functools.lru_cache(maxsize=None)
def libraries() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library, once per process."""
    libs = {}
    for name, path in build_all().items():
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def build_seconds() -> float:
    """Wall seconds to build and load every library (0 if already loaded)."""
    if libraries.cache_info().currsize:
        return 0.0
    t0 = time.perf_counter()
    libraries()
    return time.perf_counter() - t0


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# where a wrapper runs its kernel's plain version: the CPU, and the meta
# device, on which the plain version traces shapes and computes nothing
# (``launch.dryrun``)
PLAIN_DEVICES = ("cpu", "meta")


def plain_version() -> contextlib.ExitStack:
    """The context a wrapper runs its kernel's plain version in: each
    active dispatch mode with a ``plain_version`` context of its own
    enters it (``launch.roofline.StepCounter`` counts the call's memory
    as its outputs only, since the kernel allocates none of the plain
    version's temporaries)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    stack = contextlib.ExitStack()
    for mode in _get_current_dispatch_mode_stack():
        if hasattr(mode, "plain_version"):
            stack.enter_context(mode.plain_version())
    return stack


def refuse_dtensor(what: str, *tensors) -> None:
    """Raise on a ``DTensor``: a kernel takes a rank's local shard
    (``DTensor.to_local()``), whose partial results the caller combines
    over the mesh, never a DTensor (neither the launcher nor the plain
    version would see its shards)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{what} takes a rank's local shard "
                        "(DTensor.to_local()), not a DTensor")
