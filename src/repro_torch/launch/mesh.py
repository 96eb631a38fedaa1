"""Meshes and rank start-up (port of ``repro.launch.mesh``).

Mesh construction lives in ``repro_torch.sharding.mesh`` and the
collectives in ``repro_torch.comm.collectives``; this module starts
ranks: ``torchrun --nproc-per-node P`` (``init_from_env``) or
``spawn_ranks``, which starts P ranks on this host.  The functions
build nothing when imported.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

INIT_TIMEOUT_S = 60.0            # a rank's process-group timeout (seconds)
JOIN_TIMEOUT_S = 300.0           # spawn_ranks waits this long for its ranks


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def backend_for(device: str, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo (the CPU, or
    ranks sharing a card: NCCL refuses two ranks on one device)."""
    if device == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_from_env(device: str = "cuda", timeout_s: float = INIT_TIMEOUT_S
                  ) -> Tuple[int, int]:
    """Initialise the default group of a ``torchrun`` rank (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT`` from its
    environment); returns (rank, world size).  A CUDA rank first selects
    ``cuda:{LOCAL_RANK % device_count}``."""
    world = int(os.environ["WORLD_SIZE"])
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    dist.init_process_group(backend_for(device, world),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), world


def _rank_main(rank: int, fn: Callable, world: int, args: tuple, tmp: str,
               backend: str, device: str, timeout_s: float) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), *,
                device: Optional[str] = None,
                timeout_s: float = INIT_TIMEOUT_S,
                join_timeout_s: float = JOIN_TIMEOUT_S,
                backend: Optional[str] = None) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    process group and return their results in rank order.

    Each rank is a fresh process (``torch.multiprocessing``, ``spawn``):
    ``fn`` and ``args`` travel by pickle (``fn`` by import path), and so
    does each result, through a file.  The group meets at a ``file://``
    store in a fresh temporary directory, with ``timeout_s`` on its
    collectives, so a hung collective fails its rank; the parent waits
    ``join_timeout_s`` in all, then kills what is left and raises
    ``TimeoutError``.  A rank that raises or exits non-zero makes this
    raise (the others are terminated).  ``device`` resolves through
    ``repro_torch.device.resolve_device`` (None: cuda, which raises
    without a card; ``"cpu"`` on request).  ``backend`` defaults to
    ``backend_for(device, world)``; a CUDA rank r uses
    ``cuda:{r % device_count}``."""
    from repro_torch.device import resolve_device
    device = resolve_device(device).type
    backend = backend or backend_for(device, world)
    tmp = tempfile.mkdtemp(prefix="pod-ranks-")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, tuple(args), tmp, backend, device,
                              timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + join_timeout_s
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(5.0)
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{join_timeout_s:.0f} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
