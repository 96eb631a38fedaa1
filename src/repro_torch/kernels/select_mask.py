"""The edge rule of channel selection: mask a gradient matrix by its row
and column scores (port of ``repro.kernels.select_mask.select_mask_pallas``).

    keep[i, j] = (row[i] + col[j]) + rest > thr
    g̃ = where(keep, g, 0);  mask = keep;  count = Σ keep

``rest`` (the best completion through the other layers) is added after
the pair sum, exactly as ``core/channels.py`` orders it; ``rest = 0`` is
the TPU kernel's rule bitwise.  ``select_mask`` dispatches on the
tensor's device: a CPU tensor goes to ``select_mask_plain``; a CUDA
tensor launches the hand-written Hopper kernel (``csrc/select_mask.cu``)
or raises.  ``launches`` counts kernel launches only.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

Scalar = Union[float, torch.Tensor]


def reset_launches() -> None:
    global launches
    launches = 0


def select_mask_plain(g: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                      thr: torch.Tensor, rest: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g̃ like g, mask bool (M, N), count int32 0-d)."""
    keep = (row[:, None] + col[None, :]) + rest > thr
    out = torch.where(keep, g, torch.zeros_like(g))
    return out, keep, torch.count_nonzero(keep).to(torch.int32)


def _scalar(x: Scalar, device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    if t.ndim != 0:
        raise ValueError(f"threshold and rest are scalars, got shape "
                         f"{tuple(t.shape)}")
    return t


def _check(g, row, col, thr, rest) -> None:
    if g.ndim != 2 or g.shape[0] == 0 or g.shape[1] == 0:
        raise ValueError(f"select_mask takes a non-empty (M, N) matrix, "
                         f"got shape {tuple(g.shape)}")
    if g.dtype not in DTYPES:
        raise TypeError(f"select_mask takes fp32 or bf16 g, got {g.dtype}")
    m, n = g.shape
    for name, v, size in (("row", row, m), ("col", col, n)):
        if v.dtype != torch.float32 or v.shape != (size,):
            raise ValueError(f"{name} scores must be fp32 ({size},), got "
                             f"{v.dtype} {tuple(v.shape)}")
    for t in (g, row, col, thr, rest):
        if t.device != g.device:
            raise ValueError(f"select_mask operands must share a device: "
                             f"{t.device} != {g.device}")
        if not t.is_contiguous():
            raise ValueError("select_mask takes contiguous operands")


def select_mask(g: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                thr: Scalar, rest: Scalar = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g̃ like g, mask bool (M, N), count int32 0-d).

    ``thr`` and ``rest`` are fp32 scalars: Python numbers or 0-d tensors
    on g's device (a device scalar is read by the kernel, no host sync).
    """
    global launches
    thr, rest = _scalar(thr, g.device), _scalar(rest, g.device)
    _check(g, row, col, thr, rest)
    if g.device.type == "cpu":
        return select_mask_plain(g, row, col, thr, rest)
    if g.device.type != "cuda":
        raise ValueError(f"select_mask runs on cpu or cuda, not {g.device}")
    lib = build.libraries()["select_mask"]
    m, n = g.shape
    out = torch.empty_like(g)
    mask = torch.empty((m, n), dtype=torch.bool, device=g.device)
    count = torch.empty((), dtype=torch.int32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    build.check(lib.select_mask_launch(
        g.data_ptr(), DTYPES[g.dtype], m, n, row.data_ptr(), col.data_ptr(),
        thr.data_ptr(), rest.data_ptr(), out.data_ptr(), mask.data_ptr(),
        count.data_ptr(), stream), "select_mask kernel launch")
    launches += 1
    return out, mask, count
