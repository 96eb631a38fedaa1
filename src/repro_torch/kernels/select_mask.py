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
one-leaf tables.  Each wrapper dispatches on the tensors' device: CPU
tensors go to the ``*_plain`` versions (leaf by leaf); CUDA tensors
launch the hand-written Hopper kernel or raise.  ``mask_launches``,
``compact_count_launches`` and ``compact_scatter_launches`` count kernel
launches only.
"""
from __future__ import annotations

from array import array
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 2048            # entries a block takes: TILE in select_compact.cu
MAX_LEAVES = 16        # leaves a launch takes: MAX_LEAVES in both sources
_ALIGN = 16            # bytes: every output view starts 16-byte aligned

mask_launches = 0
compact_count_launches = 0
compact_scatter_launches = 0

Scalar = Union[float, torch.Tensor]
# one weight matrix's operands: (g, row, col, thr, rest)
Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Scalar, Scalar]


def reset_launches() -> None:
    global mask_launches, compact_count_launches, compact_scatter_launches
    mask_launches = compact_count_launches = compact_scatter_launches = 0


def select_mask_plain(g: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                      thr: torch.Tensor, rest: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g̃ like g, mask bool (M, N), count int32 0-d)."""
    keep = (row[:, None] + col[None, :]) + rest > thr
    out = torch.where(keep, g, torch.zeros_like(g))
    return out, keep, torch.count_nonzero(keep).to(torch.int32)


def select_compact_plain(g: torch.Tensor, row: torch.Tensor,
                         col: torch.Tensor, thr: torch.Tensor,
                         rest: torch.Tensor, capacity: int,
                         drop_zeros: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx (capacity,) int32, vals (capacity,) fp32, count int32 0-d)."""
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


def _scalar(x: Scalar, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32 and \
            x.device == device:
        t = x
    else:
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
    for t in (row, col):
        if t.device != g.device:
            raise ValueError(f"select_mask operands must share a device: "
                             f"{t.device} != {g.device}")
    if not (g.is_contiguous() and row.is_contiguous()
            and col.is_contiguous()):
        raise ValueError("select_mask takes contiguous operands")


def _leaves(leaves: Sequence[Leaf], what: str
            ) -> Tuple[List[tuple], torch.device]:
    """Checked leaves (thr and rest as 0-d fp32 tensors) and their device.
    Flat indices are int32, so M*N must be below 2^31; a CUDA table takes
    one dtype."""
    if not 0 < len(leaves) <= MAX_LEAVES:
        raise ValueError(f"{what} takes 1 to {MAX_LEAVES} leaves, got "
                         f"{len(leaves)}")
    out = []
    for g, row, col, thr, rest in leaves:
        thr, rest = _scalar(thr, g.device), _scalar(rest, g.device)
        _check(g, row, col, thr, rest)
        m, n = g.shape
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
    return out, device


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
    """Every leaf's (g̃ like g, mask bool (M, N)) and the (L,) int32 kept
    counts; on CUDA one launch, and the outputs are views of one
    allocation."""
    global mask_launches
    leaves, device = _leaves(leaves, "select_mask")
    if device.type == "cpu":
        outs = [select_mask_plain(*leaf) for leaf in leaves]
        return ([o for o, _, _ in outs], [m for _, m, _ in outs],
                torch.stack([c for _, _, c in outs]))
    dtype = leaves[0][0].dtype
    item = dtype.itemsize
    # per leaf g̃ then its mask, then the counts
    offsets, size = [], 0
    for g, *_ in leaves:
        offsets.append((size, size + _pad(g.numel() * item)))
        size = offsets[-1][1] + _pad(g.numel())
    counts_at = size
    buf = torch.empty(counts_at + _pad(4 * len(leaves)), dtype=torch.uint8,
                      device=device)
    as_vals, as_flags = buf.view(dtype), buf.view(torch.bool)
    base = buf.data_ptr()
    outs, masks, words = [], [], []
    for (g, row, col, thr, rest), (out_at, mask_at) in zip(leaves, offsets):
        m, n = g.shape
        outs.append(as_vals.as_strided((m, n), (n, 1), out_at // item))
        masks.append(as_flags.as_strided((m, n), (n, 1), mask_at))
        words += [g.data_ptr(), m, n, row.data_ptr(), col.data_ptr(),
                  thr.data_ptr(), rest.data_ptr(), base + out_at,
                  base + mask_at]
    table = _table(words)
    lib = build.libraries()["select_mask"]
    build.check(lib.select_mask_launch(
        table.buffer_info()[0], len(leaves), DTYPES[dtype],
        base + counts_at, _stream(device)), "select_mask kernel launch")
    counts = buf.view(torch.int32)[counts_at // 4:counts_at // 4 + len(leaves)]
    mask_launches += 1
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
    counts: torch.Tensor             # (L,) int32: each leaf's true kept total
    work: Optional[torch.Tensor]     # cuda: counts, tile counts, offsets
    words: Tuple[tuple, ...]         # cuda: a leaf's g, M, N, row, col,
    #                                  thr, rest words of the launch table
    first_tile: Tuple[int, ...]      # cuda: each leaf's first tile
    tiles: int                       # cuda: tiles over all leaves
    stream: int                      # cuda: the stream of the count launch


def _compact_count(leaves: List[tuple], device, drop_zeros: bool
                   ) -> CompactCounts:
    global compact_count_launches
    if device.type == "cpu":
        counts = torch.stack([select_compact_plain(*leaf, 0, drop_zeros)[2]
                              for leaf in leaves])
        return CompactCounts(tuple(leaves), drop_zeros, counts, None, (), (),
                             0, 0)
    words, first, tiles = [], [], 0
    for g, row, col, thr, rest in leaves:
        m, n = g.shape
        words.append((g.data_ptr(), m, n, row.data_ptr(), col.data_ptr(),
                      thr.data_ptr(), rest.data_ptr()))
        first.append(tiles)
        tiles += -(-m * n // TILE)
    # the counts, then the tile counts, then the large leaves' offsets
    head = _pad(len(leaves), 4)
    work = torch.empty(head + 2 * tiles, dtype=torch.int32, device=device)
    base = work.data_ptr()
    table = _table([x for l, (w, tc) in enumerate(zip(words, first))
                    for x in (*w, base + 4 * l, tc, 0, 0, 0)])
    stream = _stream(device)
    lib = build.libraries()["select_compact"]
    build.check(lib.select_compact_count_launch(
        table.buffer_info()[0], len(leaves), DTYPES[leaves[0][0].dtype],
        int(drop_zeros), base + 4 * head, base + 4 * (head + tiles), tiles,
        stream), "select_compact count launch")
    compact_count_launches += 1
    return CompactCounts(tuple(leaves), drop_zeros, work[:len(leaves)], work,
                         tuple(words), tuple(first), tiles, stream)


def compact_count(leaves: Sequence[Leaf], drop_zeros: bool = False
                  ) -> CompactCounts:
    """The count pass of ``select_compact`` over a leaf table: each
    leaf's true kept total (``.counts``, on the leaves' device); on CUDA
    one launch."""
    leaves, device = _leaves(leaves, "select_compact")
    return _compact_count(leaves, device, drop_zeros)


def compact_scatter(cc: CompactCounts, capacities: Sequence[int],
                    which: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor,
                               List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The scatter pass over the leaves ``which`` (default all) of a count
    pass, at ``capacities``: (buffer, [(idx (cap,) int32, vals (cap,)
    fp32)]), every idx and vals a view of the one int32 buffer (vals
    reinterpreted), at its ``storage_offset()``.  The unused tail is
    idx -1 / val 0, entries past a capacity drop in order.  On CUDA one
    launch (none for an empty ``which``) on the count pass's stream; no
    host sync."""
    global compact_scatter_launches
    which = list(range(len(cc.leaves))) if which is None else list(which)
    if len(capacities) != len(which) or any(c < 0 for c in capacities):
        raise ValueError(f"one capacity >= 0 a leaf, got {capacities} for "
                         f"leaves {which}")
    device = cc.counts.device
    # idx then vals, a leaf, each padded to 16 bytes
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
        for l, cap, (idx, vals) in zip(which, capacities, views):
            pidx, pvals, _ = select_compact_plain(*cc.leaves[l], cap,
                                                  cc.drop_zeros)
            idx.copy_(pidx)
            vals.copy_(pvals)
        return buf, views
    if not which:
        return buf, views
    base, work = buf.data_ptr(), cc.work.data_ptr()
    head = _pad(len(cc.leaves), 4)
    table = _table([x for l, cap, (a, b) in zip(which, capacities, spans)
                    for x in (*cc.words[l], work + 4 * l, cc.first_tile[l],
                              cap, base + 4 * a, base + 4 * b)])
    lib = build.libraries()["select_compact"]
    build.check(lib.select_compact_scatter_launch(
        table.buffer_info()[0], len(which), DTYPES[cc.leaves[0][0].dtype],
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
    leaves, device = _leaves([(g, row, col, thr, rest)], "select_compact")
    capacity = g.numel() if capacity is None else int(capacity)
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    if device.type == "cpu":
        return select_compact_plain(*leaves[0], capacity, drop_zeros)
    cc = _compact_count(leaves, device, drop_zeros)
    _, [(idx, vals)] = compact_scatter(cc, [capacity])
    return idx, vals, cc.counts[0]
