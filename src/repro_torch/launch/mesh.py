"""Meshes and the pod axis's collectives (port of ``repro.launch.mesh``).

Mesh semantics, as in the reference:
  pod   — federated client axis (one pod = one hospital/client); SCBF's
          channel-masked gradient exchange is the ONLY cross-pod traffic
  data  — batch + FSDP weight sharding
  model — tensor/expert parallelism

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the process group already initialised: ``torchrun --nproc-per-node P``
(``init_from_env``) or ``spawn_ranks``, which starts P ranks on this
host.  The functions build nothing when imported.

The port's collectives live here and nowhere else — ``gather_slots``
(every rank's slot block, in rank and so in slot order),
``all_reduce_sum`` and ``all_gather_compact`` (``(idx, vals)`` buffers
in client order).  Under NCCL they run on the device (and can be
captured in a CUDA graph); gloo takes CUDA tensors too and stages them
through the host itself (it cannot be captured).  ``calls`` and
``bytes_sent``
count what this rank put into them (the bytes of each input tensor); a
call made while a CUDA graph is being captured is not counted, since its
replays call nothing here.

Mesh construction needs a process group whose world size covers the
mesh; too few ranks raise ``RuntimeError`` in the reference's words.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

POD = "pod"
INIT_TIMEOUT_S = 60.0            # a rank's process-group timeout (seconds)
JOIN_TIMEOUT_S = 300.0           # spawn_ranks waits this long for its ranks

calls = 0
bytes_sent = 0


def reset_traffic() -> None:
    """Set ``calls`` and ``bytes_sent`` to 0."""
    global calls, bytes_sent
    calls = bytes_sent = 0


def world_size() -> int:
    """Ranks in the initialised default group (0 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 0


def _device_type() -> str:
    """The mesh's device type: cuda under NCCL, else cpu (a gloo group's
    collectives run on host buffers, whatever device its tensors use)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], need: str):
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for {need}, have {have} — start {n} ranks "
            f"(torchrun --nproc-per-node {n}, or launch.mesh.spawn_ranks) "
            "and initialise their process group first")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) with ``pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, f"mesh {shape}")


def make_host_mesh(shape=(1, 1), axes=("data", "model")):
    """A small mesh over the first ranks (a 1 × 1 mesh for CPU smoke
    tests of the sharded code path)."""
    return _mesh(tuple(shape), tuple(axes), f"mesh {tuple(shape)}")


def make_pod_mesh(num_pods: int):
    """1-D ``("pod",)`` mesh for federated cohort sharding: the batched
    engine splits a round's slot axis over it, one contiguous block of
    participant slots a rank, with weights replicated.  The world size
    must be ``num_pods``."""
    have = world_size()
    if have != num_pods:
        raise RuntimeError(
            f"need {num_pods} devices for a pod mesh, have {have} — start "
            f"{num_pods} ranks (torchrun --nproc-per-node {num_pods}, or "
            "launch.mesh.spawn_ranks) and initialise their process group "
            "first")
    return _mesh((num_pods,), (POD,), "a pod mesh")


def pod_rank(mesh) -> int:
    """This rank's coordinate on the mesh's pod axis."""
    return mesh.get_local_rank(POD)


def rank_device(device: torch.device) -> torch.device:
    """A rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a bare
    ``cuda`` (ranks that outnumber the cards share them), else
    ``device``."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _count(t: torch.Tensor) -> None:
    global calls, bytes_sent
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    calls += 1
    bytes_sent += t.numel() * t.element_size()


def gather_slots(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every pod's ``(b, …)`` block of ``t`` along axis 0, in pod order:
    ``(P·b, …)`` on every rank — the slot order of the unsplit round,
    since a rank holds the contiguous slots ``[r·b, (r+1)·b)``."""
    group = mesh.get_group(POD)
    p = mesh.size()
    _count(t)
    flag = t.dtype == torch.bool
    src = (t.view(torch.uint8) if flag else t).contiguous()
    if dist.get_backend(group) == "nccl":
        out = src.new_empty((p * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        parts = [torch.empty_like(src) for _ in range(p)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts)
    return out.view(torch.bool) if flag else out


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every pod's ``t`` (same shape), on every rank."""
    _count(t)
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(POD))
    return out


def all_gather_compact(idx: torch.Tensor, vals: torch.Tensor, mesh
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pod's compact ``(idx (k, c), vals (k, …, c))`` buffers of its
    k clients, in pod (= client) order."""
    return gather_slots(idx, mesh), gather_slots(vals, mesh)


def agree_any(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on any rank of the mesh (a control value,
    outside the traffic counters)."""
    group = mesh.get_group(POD)
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


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
                device: str = "cpu", timeout_s: float = INIT_TIMEOUT_S,
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
    raise (the others are terminated).  ``backend`` defaults to
    ``backend_for(device, world)``; a CUDA rank r uses
    ``cuda:{r % device_count}``."""
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
