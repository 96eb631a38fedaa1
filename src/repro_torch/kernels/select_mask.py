"""The edge rule of channel selection: mask a gradient matrix by its row
and column scores, or compact its kept entries into COO buffers (port of
``repro.kernels.select_mask``: ``select_mask_pallas`` and
``select_compact_pallas``).

    keep[i, j] = (row[i] + col[j]) + rest > thr
    select_mask:     g̃ = where(keep, g, 0);  mask = keep;  count = Σ keep
    select_compact:  row-major (idx, vals) of the kept entries;  count

``rest`` (the best completion through the other layers) is added after
the pair sum, exactly as ``core/channels.py`` orders it; ``rest = 0`` is
the TPU kernels' rule bitwise.  ``select_compact``'s ``drop_zeros`` also
drops kept entries that are exactly zero — the wire encoder's rule.

A client's pass is one *leaf table*: the (g, row, col, thr, rest) of
every weight matrix, taken by one launch.  ``select_mask_leaves`` masks
a table in one launch of ``csrc/select_mask.cu``; ``compact_count`` and
``compact_scatter`` are the two launches of ``csrc/select_compact.cu``,
between which a caller may read the counts (the upload encoder sizes its
buffers so).  The single-leaf ``select_mask`` and ``select_compact`` are
one-leaf tables.

A round of the batched engine is one table of *slot-stacked* leaves: a
leaf's g is ``(S, M, N)`` — the same matrix of S clients — with row
``(S, M)`` or ``(M,)``, col ``(S, N)`` or ``(N,)``, thr and rest ``(S,)``
or 0-d (an operand without the slot dimension serves every slot: slot
stride 0).  A (leaf, slot) pair is one matrix; slot s of a launch is
bitwise a one-slot launch on it.  ``compact_scatter`` takes any subset
of the count pass's pairs, each at its own capacity.

Each wrapper dispatches on the tensors' device: CPU tensors go to the
``*_plain`` versions (leaf by leaf, slot by slot); CUDA tensors launch
the hand-written Hopper kernel or raise.  A table past what one launch
takes (``MAX_LEAVES`` leaves, ``MAX_SLOTS`` (leaf, slot) pairs) raises
``ValueError`` on either device.
``mask_launches``, ``compact_count_launches`` and
``compact_scatter_launches`` count kernel launches only: a
``select_mask_leaves`` call under CUDA graph capture records its launch
into the graph and is not counted (the graph's replays launch it).
"""
from __future__ import annotations

from array import array
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 2048            # entries a block takes: TILE in select_compact.cu
MAX_LEAVES = 16        # leaves a launch takes: MAX_LEAVES in both sources
MAX_SLOTS = 4096       # (leaf, slot) pairs a launch: MAX_SLOTS in both
_ALIGN = 16            # bytes: every output view starts 16-byte aligned

mask_launches = 0
compact_count_launches = 0
compact_scatter_launches = 0

Scalar = Union[float, torch.Tensor]
# one weight matrix's operands: (g, row, col, thr, rest), or S slots of them
Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Scalar, Scalar]


def reset_launches() -> None:
    global mask_launches, compact_count_launches, compact_scatter_launches
    mask_launches = compact_count_launches = compact_scatter_launches = 0


def leaf_slot(leaf: tuple, s: int) -> tuple:
    """Slot s of a leaf (thr and rest as tensors): one matrix's operands
    (g, row, col, thr, rest); a leaf of one matrix is its own slot 0."""
    g, row, col, thr, rest = leaf
    if g.ndim == 2:
        return leaf
    return (g[s], row[s] if row.ndim == 2 else row,
            col[s] if col.ndim == 2 else col,
            thr[s] if thr.ndim == 1 else thr,
            rest[s] if rest.ndim == 1 else rest)


def select_mask_plain(g: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                      thr: torch.Tensor, rest: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g̃ like g, mask bool like g, count int32 0-d — or (S,) for a
    slot-stacked g (S, M, N), computed slot by slot)."""
    if g.ndim == 3:
        outs = [select_mask_plain(*leaf_slot((g, row, col, thr, rest), s))
                for s in range(g.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    keep = (row[:, None] + col[None, :]) + rest > thr
    out = torch.where(keep, g, torch.zeros_like(g))
    return out, keep, torch.count_nonzero(keep).to(torch.int32)


def select_compact_plain(g: torch.Tensor, row: torch.Tensor,
                         col: torch.Tensor, thr: torch.Tensor,
                         rest: torch.Tensor, capacity: int,
                         drop_zeros: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx (capacity,) int32, vals (capacity,) fp32, count int32 0-d) of
    one matrix (M, N)."""
    gf = g.to(torch.float32)
    keep = (row[:, None] + col[None, :]) + rest > thr
    if drop_zeros:
        keep = keep & (gf != 0)
    nz = torch.nonzero(keep.reshape(-1)).reshape(-1)    # row-major order
    k = min(int(nz.numel()), capacity)
    idx = torch.full((capacity,), -1, dtype=torch.int32, device=g.device)
    vals = torch.zeros((capacity,), dtype=torch.float32, device=g.device)
    idx[:k] = nz[:k].to(torch.int32)
    vals[:k] = gf.reshape(-1)[nz[:k]]
    count = torch.tensor(nz.numel(), dtype=torch.int32, device=g.device)
    return idx, vals, count


def _scalar(x: Scalar, device, slots: int) -> torch.Tensor:
    """thr or rest as fp32 on ``device``: 0-d, or (slots,) for a
    slot-stacked leaf."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32 and \
            x.device == device:
        t = x
    else:
        t = torch.as_tensor(x, dtype=torch.float32, device=device)
    if t.ndim != 0 and not (slots and tuple(t.shape) == (slots,)):
        raise ValueError(f"threshold and rest are scalars (or one a slot), "
                         f"got shape {tuple(t.shape)}")
    return t


def _check(g, row, col) -> None:
    if g.ndim not in (2, 3) or 0 in g.shape:
        raise ValueError(f"select_mask takes a non-empty (M, N) matrix or "
                         f"(S, M, N) slots of one, got shape "
                         f"{tuple(g.shape)}")
    if g.dtype not in DTYPES:
        raise TypeError(f"select_mask takes fp32 or bf16 g, got {g.dtype}")
    *slots, m, n = g.shape
    for name, v, size in (("row", row, m), ("col", col, n)):
        if v.dtype != torch.float32 or tuple(v.shape) not in (
                (size,), (*slots, size)):
            raise ValueError(f"{name} scores must be fp32 ({size},) or one "
                             f"a slot, got {v.dtype} {tuple(v.shape)}")
    for t in (row, col):
        if t.device != g.device:
            raise ValueError(f"select_mask operands must share a device: "
                             f"{t.device} != {g.device}")
    if not (g.is_contiguous() and row.is_contiguous()
            and col.is_contiguous()):
        raise ValueError("select_mask takes contiguous operands")


def _leaves(leaves: Sequence[Leaf], what: str
            ) -> Tuple[List[tuple], torch.device]:
    """Checked leaves (thr and rest as fp32 tensors) and their device.
    Flat indices are int32, so M*N must be below 2^31; a CUDA table takes
    one dtype and at most ``MAX_SLOTS`` (leaf, slot) pairs."""
    if not 0 < len(leaves) <= MAX_LEAVES:
        raise ValueError(f"{what} takes 1 to {MAX_LEAVES} leaves, got "
                         f"{len(leaves)}")
    out = []
    for g, row, col, thr, rest in leaves:
        slots = g.shape[0] if g.ndim == 3 else 0
        thr = _scalar(thr, g.device, slots)
        rest = _scalar(rest, g.device, slots)
        _check(g, row, col)
        m, n = g.shape[-2:]
        if m * n >= 2 ** 31:
            raise ValueError(f"{what} takes fewer than 2^31 entries (int32 "
                             f"flat indices), got {m} x {n}")
        out.append((g, row, col, thr, rest))
    device = out[0][0].device
    if any(leaf[0].device != device for leaf in out):
        raise ValueError(f"{what}: every leaf must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {device}")
    if device.type == "cuda" and len({leaf[0].dtype for leaf in out}) > 1:
        raise TypeError(f"{what} takes one dtype a launch on cuda")
    if sum(_slots(leaf) for leaf in out) > MAX_SLOTS:
        raise ValueError(f"{what}: a launch takes at most MAX_SLOTS = "
                         f"{MAX_SLOTS} (leaf, slot) pairs")
    return out, device


def _slots(leaf: tuple) -> int:
    g = leaf[0]
    return g.shape[0] if g.ndim == 3 else 1


def _words(leaf: tuple) -> List[int]:
    """A leaf's g, S, M, N, row, row_ss, col, col_ss, thr, thr_ss, rest,
    rest_ss words of a launch table (slot strides in floats; 0 for an
    operand every slot shares)."""
    g, row, col, thr, rest = leaf
    m, n = g.shape[-2:]
    return [g.data_ptr(), _slots(leaf), m, n,
            row.data_ptr(), m if row.ndim == 2 else 0,
            col.data_ptr(), n if col.ndim == 2 else 0,
            thr.data_ptr(), int(thr.ndim == 1),
            rest.data_ptr(), int(rest.ndim == 1)]


def _pad(n: int, unit: int = _ALIGN) -> int:
    return -(-n // unit) * unit


def _table(words: List[int]) -> array:
    """The launch's leaf table: int64 words on the host, read by the
    launcher before it returns (pass ``.buffer_info()[0]``, and keep the
    array alive across the call)."""
    return array("q", words)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def select_mask_leaves(leaves: Sequence[Leaf]
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                  torch.Tensor]:
    """Every leaf's (g̃ like g, mask bool like g) and the int32 kept
    counts, one a (leaf, slot) pair, leaf by leaf (``(L,)`` for a table of
    matrices); on CUDA one launch, and the outputs are views of one
    allocation."""
    global mask_launches
    leaves, device = _leaves(leaves, "select_mask")
    if device.type == "cpu":
        outs = [select_mask_plain(*leaf) for leaf in leaves]
        return ([o for o, _, _ in outs], [m for _, m, _ in outs],
                torch.cat([c.reshape(-1) for _, _, c in outs]))
    dtype = leaves[0][0].dtype
    item = dtype.itemsize
    # per leaf g̃ then its mask, then the counts
    offsets, size = [], 0
    for g, *_ in leaves:
        offsets.append((size, size + _pad(g.numel() * item)))
        size = offsets[-1][1] + _pad(g.numel())
    counts_at = size
    pairs = sum(_slots(leaf) for leaf in leaves)
    buf = torch.empty(counts_at + _pad(4 * pairs), dtype=torch.uint8,
                      device=device)
    as_vals, as_flags = buf.view(dtype), buf.view(torch.bool)
    base = buf.data_ptr()
    outs, masks, words = [], [], []
    for leaf, (out_at, mask_at) in zip(leaves, offsets):
        g = leaf[0]
        outs.append(as_vals[out_at // item:out_at // item + g.numel()]
                    .view(g.shape))
        masks.append(as_flags[mask_at:mask_at + g.numel()].view(g.shape))
        words += _words(leaf) + [base + out_at, base + mask_at]
    table = _table(words)
    lib = build.libraries()["select_mask"]
    build.check(lib.select_mask_launch(
        table.buffer_info()[0], len(leaves), DTYPES[dtype],
        base + counts_at, _stream(device)), "select_mask kernel launch")
    counts = buf.view(torch.int32)[counts_at // 4:counts_at // 4 + pairs]
    if not torch.cuda.is_current_stream_capturing():
        mask_launches += 1          # recorded into a graph: not launched
    return outs, masks, counts


def select_mask(g: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                thr: Scalar, rest: Scalar = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g̃ like g, mask bool (M, N), count int32 0-d): a one-leaf table.

    ``thr`` and ``rest`` are fp32 scalars: Python numbers or 0-d tensors
    on g's device (a device scalar is read by the kernel, no host sync).
    M*N must be below 2^31.
    """
    (out,), (mask,), counts = select_mask_leaves([(g, row, col, thr, rest)])
    return out, mask, counts[0]


class CompactCounts(NamedTuple):
    """A count pass over a leaf table: the counts and what the scatter
    pass needs."""

    leaves: Tuple[tuple, ...]        # checked (g, row, col, thr, rest)
    drop_zeros: bool
    counts: torch.Tensor             # one int32 a pair: its true kept total
    pairs: Tuple[Tuple[int, int], ...]   # (leaf, slot) of each count
    work: Optional[torch.Tensor]     # cuda: counts, tile counts, offsets
    rows: Tuple[tuple, ...]          # cuda: each leaf's table row
    tiles: int                       # cuda: tiles over all pairs
    stream: int                      # cuda: the stream of the count launch


def _compact_count(leaves: List[tuple], device, drop_zeros: bool
                   ) -> CompactCounts:
    global compact_count_launches
    pairs = tuple((l, s) for l, leaf in enumerate(leaves)
                  for s in range(_slots(leaf)))
    if device.type == "cpu":
        counts = torch.stack([
            select_compact_plain(*leaf_slot(leaves[l], s), 0, drop_zeros)[2]
            for l, s in pairs])
        return CompactCounts(tuple(leaves), drop_zeros, counts, pairs, None,
                             (), 0, 0)
    # the counts, then the tile counts, then the large matrices' offsets
    head = _pad(len(pairs), 4)
    tiles = sum(_slots(leaf) * -(-leaf[0].shape[-2] * leaf[0].shape[-1]
                                 // TILE) for leaf in leaves)
    work = torch.empty(head + 2 * tiles, dtype=torch.int32, device=device)
    base = work.data_ptr()
    rows, tc, pair = [], 0, 0
    for leaf in leaves:
        rows.append(tuple(_words(leaf) + [base + 4 * pair, tc, pair]))
        m, n = leaf[0].shape[-2:]
        tc += _slots(leaf) * -(-m * n // TILE)
        pair += _slots(leaf)
    table = _table([x for row in rows for x in row])
    stream = _stream(device)
    lib = build.libraries()["select_compact"]
    build.check(lib.select_compact_count_launch(
        table.buffer_info()[0], len(leaves), DTYPES[leaves[0][0].dtype],
        int(drop_zeros), base + 4 * head, base + 4 * (head + tiles), tiles,
        stream), "select_compact count launch")
    compact_count_launches += 1
    return CompactCounts(tuple(leaves), drop_zeros, work[:len(pairs)], pairs,
                         work, tuple(rows), tiles, stream)


def compact_count(leaves: Sequence[Leaf], drop_zeros: bool = False
                  ) -> CompactCounts:
    """The count pass of ``select_compact`` over a leaf table: each (leaf,
    slot) pair's true kept total (``.counts``, on the leaves' device, in
    the order of ``.pairs``); on CUDA one launch."""
    leaves, device = _leaves(leaves, "select_compact")
    return _compact_count(leaves, device, drop_zeros)


def compact_scatter(cc: CompactCounts, capacities: Sequence[int],
                    which: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor,
                               List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The scatter pass over the pairs ``which`` (indices into
    ``cc.pairs``, default all) of a count pass, at ``capacities``:
    (buffer, [(idx (cap,) int32, vals (cap,) fp32)]), every idx and vals a
    view of the one int32 buffer (vals reinterpreted), at its
    ``storage_offset()``.  The unused tail is idx -1 / val 0, entries past
    a capacity drop in order.  On CUDA one launch (none for an empty
    ``which``) on the count pass's stream, which first copies the pairs'
    table to the device; no host sync."""
    global compact_scatter_launches
    which = list(range(len(cc.pairs))) if which is None else list(which)
    if len(capacities) != len(which) or any(c < 0 for c in capacities):
        raise ValueError(f"one capacity >= 0 a pair, got {capacities} for "
                         f"pairs {which}")
    device = cc.counts.device
    # idx then vals, a pair, each padded to 16 bytes
    spans, pieces, size = [], [], 0
    for cap in capacities:
        pad = _pad(cap, 4)
        spans.append((size, size + pad))
        pieces += [cap, pad - cap] * 2
        size += 2 * pad
    buf = torch.empty(size, dtype=torch.int32, device=device)
    as_int = buf.split(pieces)
    as_float = buf.view(torch.float32).split(pieces)
    views = [(as_int[4 * k], as_float[4 * k + 2])
             for k in range(len(capacities))]
    if device.type == "cpu":
        for k, cap, (idx, vals) in zip(which, capacities, views):
            l, s = cc.pairs[k]
            pidx, pvals, _ = select_compact_plain(
                *leaf_slot(cc.leaves[l], s), cap, cc.drop_zeros)
            idx.copy_(pidx)
            vals.copy_(pvals)
        return buf, views
    if not which:
        return buf, views
    head = _pad(len(cc.pairs), 4)
    work = cc.work.data_ptr()
    rows = _table([x for row in cc.rows for x in row])
    pairs = _table([x for k, cap, (a, b) in zip(which, capacities, spans)
                    for x in (*cc.pairs[k], cap, a, b)])
    lib = build.libraries()["select_compact"]
    build.check(lib.select_compact_scatter_launch(
        rows.buffer_info()[0], len(cc.leaves), pairs.buffer_info()[0],
        len(which), buf.data_ptr(), DTYPES[cc.leaves[0][0].dtype],
        int(cc.drop_zeros), work + 4 * head, work + 4 * (head + cc.tiles),
        cc.tiles, cc.stream), "select_compact scatter launch")
    compact_scatter_launches += 1
    return buf, views


def select_compact(g: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                   thr: Scalar, rest: Scalar = 0.0,
                   capacity: Optional[int] = None, drop_zeros: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx (capacity,) int32, vals (capacity,) fp32, count int32 0-d).

    The kept entries' flat indices and values (fp32, whatever g's dtype)
    in row-major order; the unused tail is idx -1 / val 0, entries past
    ``capacity`` (default M*N) drop in order, and ``count`` is the true
    kept total.  ``drop_zeros`` keeps only nonzero entries.  Flat indices
    are int32, so M*N must be below 2^31.  CUDA: the count and the scatter
    launch back to back, no host sync; bitwise the plain version.
    """
    if g.ndim != 2:
        raise ValueError(f"select_compact takes one (M, N) matrix, got "
                         f"shape {tuple(g.shape)}")
    leaves, device = _leaves([(g, row, col, thr, rest)], "select_compact")
    capacity = g.numel() if capacity is None else int(capacity)
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    if device.type == "cpu":
        return select_compact_plain(*leaves[0], capacity, drop_zeros)
    cc = _compact_count(leaves, device, drop_zeros)
    _, [(idx, vals)] = compact_scatter(cc, [capacity])
    return idx, vals, cc.counts[0]
