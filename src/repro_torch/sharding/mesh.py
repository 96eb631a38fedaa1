"""Device meshes over the initialised process group (the construction
half of ``repro.launch.mesh``; ``launch.mesh`` re-exports it beside rank
start-up).

Mesh semantics, as in the reference:
  pod   — federated client axis (one pod = one hospital/client); SCBF's
          channel-masked gradient exchange is the ONLY cross-pod traffic
  data  — batch + FSDP weight sharding
  model — tensor/expert parallelism

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose device
type is the device its tensors live on: ``cuda`` for ranks on cards
(under NCCL, or gloo ranks sharing one card), ``cpu`` for CPU ranks.
DTensor places its shards on the mesh's device type, so a mesh of
another type than the tensors would move them; ``device`` says it, and
left out it is cuda (``repro_torch.device.resolve_device``: without a
card that raises, and only a caller that asks for ``"cpu"`` gets a CPU
mesh).  Too few ranks raise ``RuntimeError`` in the reference's words.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

POD = "pod"


def world_size() -> int:
    """Ranks in the initialised default group (0 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 0


def _device_type(device=None) -> str:
    """The device type of a mesh whose tensors live on ``device`` (None:
    cuda, which raises without a card)."""
    from repro_torch.device import resolve_device
    return resolve_device(device).type


def build_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], need: str,
               device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first ranks of
    the default group."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for {need}, have {have} — start {n} ranks "
            f"(torchrun --nproc-per-node {n}, or launch.mesh.spawn_ranks) "
            "and initialise their process group first")
    kind = _device_type(device)
    if kind == "cuda" and dist.get_backend() == "gloo":
        stage_gloo_gathers()
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


_staged = []


def stage_gloo_gathers() -> None:
    """Route DTensor's all-gathers and all-to-alls of CUDA tensors through
    host buffers, for gloo ranks on cards (ranks sharing one card, which
    NCCL refuses).  Gloo's own CUDA path of these two (PyTorch 2.11 on
    the H100 host) ends the rank with a segmentation fault, while its
    all-reduce and reduce-scatter of CUDA tensors, and its host
    collectives, work; so each is a host all-gather whose result is
    copied back to the card.  Only the transport moves: every operation
    on the data stays on the card.  Installed once a process, by the
    first CUDA mesh built under gloo."""
    if _staged:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    dt = torch.library.Library("_dtensor", "IMPL")
    ops = torch.ops._c10d_functional

    def gather(t, group_size, group_name):
        out = ops.wait_tensor(ops.all_gather_into_tensor(
            t.cpu(), group_size, group_name))
        return out.to(t.device)

    def alltoall(t, gather_dim, shard_dim, group_name):
        parts = dist.distributed_c10d._resolve_process_group(group_name)
        size, rank = parts.size(), parts.rank()
        full = gather(torch.movedim(t, gather_dim, 0).contiguous(), size,
                      group_name)
        full = torch.movedim(full, 0, gather_dim)
        return torch.chunk(full, size, dim=shard_dim)[rank].contiguous()

    lib.impl("all_gather_into_tensor", gather, "CUDA")
    dt.impl("shard_dim_alltoall", alltoall, "CUDA")
    _staged.extend([lib, dt])


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) with ``pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes, f"mesh {shape}", device)


def make_host_mesh(shape=(1, 1), axes=None, device=None):
    """A mesh over the first ranks: ``(data, model)`` for a 2-D shape,
    ``(pod, data, model)`` for a 3-D one (a 1 × 1 mesh for the CPU smoke
    tests of the sharded code path)."""
    shape = tuple(shape)
    if axes is None:
        axes = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
    return build_mesh(shape, tuple(axes), f"mesh {shape}", device)


def make_pod_mesh(num_pods: int, device=None):
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
    return build_mesh((num_pods,), (POD,), "a pod mesh", device)


def num_pods(mesh) -> int:
    """The size of the mesh's pod axis (1 without one)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(POD)) if POD in names else 1


def pod_rank(mesh) -> int:
    """This rank's coordinate on the mesh's pod axis (0 without one)."""
    return mesh.get_local_rank(POD) if POD in (mesh.mesh_dim_names or ()) \
        else 0


def rank_device(device: torch.device) -> torch.device:
    """A rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a bare
    ``cuda`` (ranks that outnumber the cards share them), else
    ``device``."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def is_sharded(mesh: Optional[object]) -> bool:
    """Whether ``mesh`` has a ``data`` or ``model`` axis above 1."""
    if mesh is None:
        return False
    names = mesh.mesh_dim_names or ()
    return any(mesh.size(names.index(a)) > 1 for a in ("data", "model")
               if a in names)
