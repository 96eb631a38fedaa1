"""The port's collectives and what they carry.

Two families, each with its byte counter:

* the pod axis (PR 23's federated exchange): ``gather_slots`` (every
  rank's slot block, in rank and so in slot order), ``all_reduce_sum``,
  ``all_gather_compact`` (``(idx, vals)`` buffers in client order),
  ``all_gather_ragged`` (entries whose count differs from pod to pod,
  padded only to the largest count) and ``agree_any`` (a control flag,
  uncounted).  ``calls`` and
  ``bytes_sent`` count what this rank put into them — SCBF's masked
  exchange, the only traffic that crosses pods;
* the shards of one pod's ``(data, model)`` mesh, for SCBF's selection on
  sharded gradients: ``shard_sum`` all-reduces a shard's partial channel
  norms (or its kept counts) over the mesh axes that split the rows, and
  ``shard_gather`` all-gathers score slices over the axes that split the
  columns.  ``traffic("mesh")`` counts them.

``by_kind`` splits both families' counts by kind of collective, with
the bytes put in and the bytes each moves over the rank's links
(``link_bytes``).

Under NCCL they run on the device (and can be captured in a CUDA graph);
gloo takes CUDA tensors too and stages them through the host itself.  A
call made while a CUDA graph is being captured is not counted, since its
replays call nothing here.  The collectives DTensor issues itself
(FSDP all-gathers, tensor-parallel reductions) are counted by
``launch.roofline.StepCounter``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

POD = "pod"

calls = 0
bytes_sent = 0
# (family "pod" or "mesh", kind "all-gather" or "all-reduce")
#   -> [calls, bytes put in, bytes over the rank's links]
by_kind: dict = {}


def reset_traffic() -> None:
    """Set every counter to 0."""
    global calls, bytes_sent
    calls = bytes_sent = 0
    by_kind.clear()


def traffic(family: str) -> Tuple[int, int]:
    """(calls, bytes) this rank put into one family's collectives."""
    got = [v for (f, _), v in by_kind.items() if f == family]
    return sum(v[0] for v in got), sum(v[1] for v in got)


def link_bytes(kind: str, n: int, parts: int) -> int:
    """Bytes a rank sends over its links in a ring collective of ``parts``
    ranks whose input holds ``n`` bytes on that rank: the other ranks'
    slices, (P-1)·n, for an all-gather; (P-1)/P·n for a reduce-scatter
    or an all-to-all; 2(P-1)/P·n for an all-reduce; n for a broadcast."""
    if kind == "all-gather":
        return (parts - 1) * n
    if kind == "all-reduce":
        return 2 * (parts - 1) * n // parts
    if kind in ("reduce-scatter", "all-to-all"):
        return (parts - 1) * n // parts
    return n


def _tally(family: str, kind: str, n: int, parts: int) -> None:
    got = by_kind.setdefault((family, kind), [0, 0, 0])
    got[0] += 1
    got[1] += n
    got[2] += link_bytes(kind, n, parts)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _parts(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _count(t: torch.Tensor, kind: str, mesh) -> None:
    global calls, bytes_sent
    if _capturing(t):
        return
    calls += 1
    bytes_sent += t.numel() * t.element_size()
    _tally("pod", kind, t.numel() * t.element_size(), _parts(mesh, POD))


def _count_mesh(t: torch.Tensor, kind: str, mesh, axis: str) -> None:
    if not _capturing(t):
        _tally("mesh", kind, t.numel() * t.element_size(),
               _parts(mesh, axis))


def _gather(src: torch.Tensor, group, parts: int) -> torch.Tensor:
    """``parts`` ranks' ``src`` stacked along axis 0, in rank order."""
    if dist.get_backend(group) == "nccl":
        out = src.new_empty((parts * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out
    got = [torch.empty_like(src) for _ in range(parts)]
    dist.all_gather(got, src, group=group)
    return torch.cat(got)


# ---------------------------------------------------------------------------
# the pod axis
# ---------------------------------------------------------------------------

def gather_slots(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every pod's ``(b, …)`` block of ``t`` along axis 0, in pod order:
    ``(P·b, …)`` on every rank — the slot order of the unsplit round,
    since a rank holds the contiguous slots ``[r·b, (r+1)·b)``."""
    group = mesh.get_group(POD)
    _count(t, "all-gather", mesh)
    flag = t.dtype == torch.bool
    src = (t.view(torch.uint8) if flag else t).contiguous()
    out = _gather(src, group, _parts(mesh, POD))
    return out.view(torch.bool) if flag else out


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every pod's ``t`` (same shape), on every rank."""
    _count(t, "all-reduce", mesh)
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(POD))
    return out


def all_gather_compact(idx: torch.Tensor, vals: torch.Tensor, mesh
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pod's compact ``(idx (k, c), vals (k, …, c))`` buffers of its
    k clients, in pod (= client) order."""
    return gather_slots(idx, mesh), gather_slots(vals, mesh)


def all_gather_ragged(idx: torch.Tensor, vals: torch.Tensor, mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pod's entries ``(idx (m,), vals (…, m))`` joined along the
    last axis in pod (= client) order, where ``m`` differs from pod to
    pod (a column-split leaf's selected channels that fall in this
    rank's columns).  The counts are gathered first (one int64 each),
    then every pod's buffers are padded to the largest count, not to a
    capacity, and cut back after the gather.  On the meta device (the
    dry run) the counts cross but hold nothing, and every pod's is taken
    as this rank's."""
    m = idx.shape[0]
    counts = gather_slots(torch.tensor([m], dtype=torch.int64,
                                       device=idx.device), mesh)
    counts = [m] * _parts(mesh, POD) if idx.is_meta else counts.tolist()
    pad = max(counts) - m
    got_idx = gather_slots(torch.nn.functional.pad(idx, (0, pad))[None],
                           mesh)
    got_vals = gather_slots(torch.nn.functional.pad(vals, (0, pad))[None],
                            mesh)
    return (torch.cat([got_idx[p, :c] for p, c in enumerate(counts)]),
            torch.cat([got_vals[p, ..., :c] for p, c in enumerate(counts)],
                      axis=-1))


def agree_any(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on any rank of the mesh (a control value,
    outside the traffic counters)."""
    group = mesh.get_group(POD)
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


# ---------------------------------------------------------------------------
# the shards of a (data, model) mesh
# ---------------------------------------------------------------------------

def shard_sum(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the mesh axes ``axes`` (a
    shard's partial channel norms, or its kept counts), one all-reduce an
    axis; ``t`` itself where ``axes`` is empty."""
    for name in axes:
        _count_mesh(t, "all-reduce", mesh, name)
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(name))
    return t


def shard_gather(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The slices ``t (…, n)`` of the ranks of the mesh axes ``axes``
    joined along the last axis, in the order of a tensor dimension split
    over ``axes`` (the first axis outermost), one all-gather an axis."""
    for name in reversed(axes):
        _count_mesh(t, "all-gather", mesh, name)
        parts = _parts(mesh, name)
        src = torch.movedim(t, -1, 0).contiguous()
        # gloo's list form (its CUDA all_gather_into_tensor can fault);
        # not ``_gather``, which the pod path's padded slot stacks share
        got = [torch.empty_like(src) for _ in range(parts)]
        dist.all_gather(got, src, group=mesh.get_group(name))
        t = torch.movedim(torch.cat(got), 0, -1).contiguous()
    return t
