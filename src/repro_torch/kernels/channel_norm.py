"""Channel norms of gradient matrices: row and column squared norms in one
pass (port of ``repro.kernels.channel_norm.channel_norms_pallas``).

A client's pass is one *leaf table*: every weight matrix, taken by one
launch of ``csrc/channel_norm.cu`` (``channel_norms_leaves``); the
single-matrix ``channel_norms`` is a one-leaf table.  A round of the
batched engine is one table of *slot-stacked* leaves: a leaf ``(S, M, N)``
holds the same matrix of S clients and gives ``(S, M)`` and ``(S, N)``
norms, slot s bitwise what a one-slot launch on ``g[s]`` gives.  Each wrapper
dispatches on the tensors' device: CPU tensors go to
``channel_norms_plain`` leaf by leaf; CUDA tensors launch the
hand-written Hopper kernel or raise.  ``launches`` counts kernel launches
only.

The kernel keeps its cross-block partials and tickets in a *workspace*:
one zeroed int32 tensor a device, owned here (``workspace``), which every
launch leaves zeroed.  It grows (a new zeroed tensor) when a table needs
more than it holds (to at least twice its size), so a round of any number
of slots is one launch.  A CUDA graph captures its address: size it before
a capture (a warm-up call does), and keep a reference to it while the
graph lives (``fed.graphs.RoundProgram`` does); an outgrown workspace is
freed once nothing holds it.  A call under CUDA graph capture records the
launch into the graph and launches nothing, so ``launches`` leaves it
out; the graph's replays launch the kernel.
"""
from __future__ import annotations

from array import array
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEAVES = 16            # leaves a launch takes: MAX_LEAVES in the source
TILE_ROWS, STRIP = 96, 64   # a tile of the kernel: TILE_ROWS x STRIP

launches = 0
_workspaces: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    global launches
    launches = 0


def channel_norms_plain(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row (M,), col (N,)) squared norms of g (M, N), fp32; a
    slot-stacked g (S, M, N) gives (S, M) and (S, N), slot by slot."""
    if g.ndim == 3:
        rows, cols = zip(*(channel_norms_plain(gs) for gs in g))
        return torch.stack(rows), torch.stack(cols)
    gf = g.to(torch.float32)
    sq = gf * gf
    return torch.sum(sq, axis=-1), torch.sum(sq, axis=-2)


def _check(g: torch.Tensor) -> None:
    if g.ndim not in (2, 3) or 0 in g.shape:
        raise ValueError(f"channel_norms takes a non-empty (M, N) matrix or "
                         f"(S, M, N) slots of one, got shape "
                         f"{tuple(g.shape)}")
    if g.dtype not in DTYPES:
        raise TypeError(f"channel_norms takes fp32 or bf16, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("channel_norms takes a contiguous (row-major) matrix")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def workspace_words(gs: Sequence[torch.Tensor]) -> int:
    """32-bit words of workspace a launch over ``gs`` takes: the same sums
    as the launcher's, over every slot — the partials of every slot of
    more than one tile row (row tiles x N) or column strip (strips x M),
    and a ticket for each of their column strips and tile rows."""
    words = 0
    for g in gs:
        s, m, n = _slot_shape(g)
        nrt, nct = _cdiv(m, TILE_ROWS), _cdiv(n, STRIP)
        if nrt > 1:
            words += s * (nrt * n + nct)
        if nct > 1:
            words += s * (nct * m + nrt)
    return words


def workspace(device) -> Optional[torch.Tensor]:
    """The device's workspace tensor (None before the first launch)."""
    return _workspaces.get(torch.device(device))


def _workspace(device: torch.device, words: int) -> torch.Tensor:
    """The device's workspace, grown to hold ``words`` (a new zeroed
    tensor on the current stream, at least twice the old one's size).
    Growing is refused during a CUDA graph capture, whose allocation would
    belong to the graph."""
    ws = _workspaces.get(device)
    if ws is None or ws.numel() < words:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"channel_norms: the workspace holds "
                f"{0 if ws is None else ws.numel()} words and the table "
                f"needs {words}; size it before a CUDA graph capture (run "
                f"the captured function once first)")
        size = max(words, 1 if ws is None else 2 * ws.numel())
        ws = torch.zeros(size, dtype=torch.int32, device=device)
        _workspaces[device] = ws
    return ws


def _slot_shape(g: torch.Tensor) -> Tuple[int, int, int]:
    """(S, M, N) of a leaf: a 2-D matrix is one slot."""
    return (1, *g.shape) if g.ndim == 2 else tuple(g.shape)


def channel_norms_leaves(gs: Sequence[torch.Tensor]
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every matrix's (row (M,), col (N,)) squared norms, fp32; a
    slot-stacked leaf (S, M, N) gives (S, M) and (S, N).

    The leaves share one device and one dtype (fp32 or bf16), at most
    ``MAX_LEAVES``.  CPU: the plain version leaf by leaf (slot by slot).
    CUDA: one launch, the outputs views of one allocation; deterministic
    (no float atomics: two launches on the same input are bitwise equal,
    and slot s of a slot-stacked leaf is bitwise a one-slot launch on
    it).  The device's workspace grows to the table first
    (``workspace_words``).
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
    # per leaf rows then cols, each from a 16-byte boundary
    spans, size = [], 0
    for g in gs:
        s, m, n = _slot_shape(g)
        spans.append((size, size + _cdiv(s * m, 4) * 4))
        size = spans[-1][1] + _cdiv(s * n, 4) * 4
    buf = torch.empty(size, dtype=torch.float32, device=device)
    base = buf.data_ptr()
    out, words = [], []
    for g, (r_at, c_at) in zip(gs, spans):
        s, m, n = _slot_shape(g)
        row, col = buf[r_at:r_at + s * m], buf[c_at:c_at + s * n]
        out.append((row, col) if g.ndim == 2 else
                   (row.view(s, m), col.view(s, n)))
        words += [g.data_ptr(), s, m, n, base + 4 * r_at, base + 4 * c_at]
    table = array("q", words)
    ws = _workspace(device, workspace_words(gs))
    lib = build.libraries()["channel_norm"]
    build.check(lib.channel_norms_launch(
        table.buffer_info()[0], len(gs), DTYPES[dtype], ws.data_ptr(),
        ws.numel(), torch.cuda.current_stream(device).cuda_stream),
        "channel_norms kernel launch")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1               # recorded into a graph: not launched
    return out


def channel_norms(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row (M,), col (N,)) squared norms of g (M, N), accumulated in fp32:
    a one-leaf table."""
    return channel_norms_leaves([g])[0]
