"""Channel norms of gradient matrices: row and column squared norms in one
pass (port of ``repro.kernels.channel_norm.channel_norms_pallas``).

A client's pass is one *leaf table*: every weight matrix, taken by one
launch of ``csrc/channel_norm.cu`` (``channel_norms_leaves``); the
single-matrix ``channel_norms`` is a one-leaf table.  Each wrapper
dispatches on the tensors' device: CPU tensors go to
``channel_norms_plain`` leaf by leaf; CUDA tensors launch the
hand-written Hopper kernel or raise.  ``launches`` counts kernel launches
only.
"""
from __future__ import annotations

from array import array
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEAVES = 16            # leaves a launch takes: MAX_LEAVES in the source
TILE_ROWS, STRIP = 96, 64   # a tile of the kernel: TILE_ROWS x STRIP
SCRATCH = 1 << 22          # floats of partials a launch: SCRATCH
MAX_TICKETS = 1 << 16      # strips of each kind a launch: MAX_TICKETS

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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_scratch(gs: Sequence[torch.Tensor]) -> None:
    """The launch's partials and tickets fit the library's: the same sums
    as the launcher's."""
    floats = col_tk = row_tk = 0
    for g in gs:
        m, n = g.shape
        nrt, nct = _cdiv(m, TILE_ROWS), _cdiv(n, STRIP)
        if nrt > 1:
            floats, col_tk = floats + nrt * n, col_tk + nct
        if nct > 1:
            floats, row_tk = floats + nct * m, row_tk + nrt
    if floats > SCRATCH or max(col_tk, row_tk) > MAX_TICKETS:
        raise ValueError(f"channel_norms: the table needs {floats} floats of "
                         f"partials (at most {SCRATCH}) and {col_tk} + "
                         f"{row_tk} strips (at most {MAX_TICKETS} each)")


def channel_norms_leaves(gs: Sequence[torch.Tensor]
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every matrix's (row (M,), col (N,)) squared norms, fp32.

    The matrices share one device and one dtype (fp32 or bf16), at most
    ``MAX_LEAVES``.  CPU: the plain version leaf by leaf.  CUDA: one
    launch, the outputs views of one allocation; deterministic (no float
    atomics: two launches on the same input are bitwise equal).
    """
    global launches
    if not 0 < len(gs) <= MAX_LEAVES:
        raise ValueError(f"channel_norms takes 1 to {MAX_LEAVES} leaves, got "
                         f"{len(gs)}")
    for g in gs:
        _check(g)
    device, dtype = gs[0].device, gs[0].dtype
    if any(g.device != device for g in gs):
        raise ValueError("channel_norms: every leaf must be on one device")
    if any(g.dtype != dtype for g in gs):
        raise TypeError("channel_norms takes one dtype a table")
    if device.type == "cpu":
        return [channel_norms_plain(g) for g in gs]
    if device.type != "cuda":
        raise ValueError(f"channel_norms runs on cpu or cuda, not {device}")
    _check_scratch(gs)
    # per leaf row then col, each from a 16-byte boundary
    spans, size = [], 0
    for g in gs:
        m, n = g.shape
        spans.append((size, m, size + _cdiv(m, 4) * 4, n))
        size = spans[-1][2] + _cdiv(n, 4) * 4
    buf = torch.empty(size, dtype=torch.float32, device=device)
    base = buf.data_ptr()
    out, words = [], []
    for g, (r_at, m, c_at, n) in zip(gs, spans):
        out.append((buf[r_at:r_at + m], buf[c_at:c_at + n]))
        words += [g.data_ptr(), m, n, base + 4 * r_at, base + 4 * c_at]
    table = array("q", words)
    lib = build.libraries()["channel_norm"]
    build.check(lib.channel_norms_launch(
        table.buffer_info()[0], len(gs), DTYPES[dtype],
        torch.cuda.current_stream(device).cuda_stream),
        "channel_norms kernel launch")
    launches += 1
    return out


def channel_norms(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row (M,), col (N,)) squared norms of g (M, N), accumulated in fp32:
    a one-leaf table."""
    return channel_norms_leaves([g])[0]
