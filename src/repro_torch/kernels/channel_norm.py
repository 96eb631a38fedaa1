"""Channel norms of a gradient matrix: row and column squared norms in one
pass (port of ``repro.kernels.channel_norm.channel_norms_pallas``).

``channel_norms`` dispatches on the tensor's device: a CPU tensor goes to
``channel_norms_plain``; a CUDA tensor launches the hand-written Hopper
kernel (``csrc/channel_norm.cu``) or raises.  ``launches`` counts kernel
launches only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def channel_norms_plain(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row (M,), col (N,)) squared norms of g (M, N), fp32."""
    gf = g.to(torch.float32)
    sq = gf * gf
    return torch.sum(sq, dim=1), torch.sum(sq, dim=0)


def _check(g: torch.Tensor) -> None:
    if g.ndim != 2 or g.shape[0] == 0 or g.shape[1] == 0:
        raise ValueError(f"channel_norms takes a non-empty (M, N) matrix, "
                         f"got shape {tuple(g.shape)}")
    if g.dtype not in DTYPES:
        raise TypeError(f"channel_norms takes fp32 or bf16, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("channel_norms takes a contiguous (row-major) matrix")


def channel_norms(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row (M,), col (N,)) squared norms of g (M, N), accumulated in fp32.

    CPU: the plain version.  CUDA: the kernel, deterministic (no float
    atomics; two launches on the same input are bitwise equal).
    """
    global launches
    _check(g)
    if g.device.type == "cpu":
        return channel_norms_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"channel_norms runs on cpu or cuda, not {g.device}")
    lib = build.libraries()["channel_norm"]
    m, n = g.shape
    row = torch.empty((m,), dtype=torch.float32, device=g.device)
    col = torch.empty((n,), dtype=torch.float32, device=g.device)
    work = torch.empty((lib.channel_norms_workspace(m, n),),
                       dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    build.check(lib.channel_norms_launch(
        g.data_ptr(), DTYPES[g.dtype], m, n, row.data_ptr(), col.data_ptr(),
        work.data_ptr(), stream), "channel_norms kernel launch")
    launches += 1
    return row, col
