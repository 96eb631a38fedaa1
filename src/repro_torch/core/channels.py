"""Channel-norm algebra — the paper's §2.1 "Compute Channel Norms" step.

Port of ``repro.core.channels`` (see its docstring for the derivation).
The channel norm is separable, T[i1, …, iL] = Σ_l s_l[i_l] with
s_l[i] = Σ_p G_l[p, i]² + (∂b_l[i])², so the exact α-quantile needs only
the broadcast sum of L vectors and the edge rule needs only pair sums:

    s_{l-1}[p] + s_l[q] + Σ_{j∉{l-1,l}} max_i s_j[i]  >  q_α

Two kernels carry the per-client pass, each in one launch over every
weight matrix: ``kernels.channel_norm`` gives the column norms behind
``layer_scores`` and ``kernels.select_mask`` applies the edge rule;
``edge_operands`` hands the same rule to the upload encoder
(``comm.wire.encode_selected``).  The rest is plain torch.  All
scores are fp32 regardless of gradient dtype.

Slot-stacked deltas (the batched engine: S clients of a round, every
weight ``(S, M, N)`` and bias ``(S, m)``) run the same algebra slot by
slot in one pass: scores ``(S, m_l)`` from one channel-norm launch, one
threshold a slot (a sort along the last axis), edge operands with
``thr`` and ``rest`` of shape ``(S,)``, and one select-mask launch a
group of slots that fits its ``MAX_SLOTS`` (leaf, slot) pairs
(``slot_groups``: one group up to 1,365 slots of the 3-layer MLP).  Slot
s gives what the one-client functions give on it, bitwise.

The LM scenario (``core.distributed``) scores any param tree by
*factored* channel scores (``factored_scores``, ``factored_threshold``,
``apply_factored_mask``): the same two kernels, one launch each a table
of at most ``MAX_LEAVES`` leaves (``leaf_tables``) of every client.

Sharded gradients (DTensor leaves on a ``(data, model)`` mesh, each with
its parameter's placements behind the client axis): each rank launches
K1 and K2 on its local shards, one launch each a leaf table as on one
device.  K1's partial column norms are summed over the mesh axes that
split a leaf's rows and the column slices gathered over the axis that
splits its columns (``comm.collectives.shard_sum`` / ``shard_gather``:
N fp32 scores a leaf and client), so every rank holds the whole score
pool and takes the one global threshold; K2 masks the local shard
against its slice of the scores, and the kept counts are summed (int64)
over the axes that split the leaf.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import collectives
from repro_torch.kernels import channel_norm as channel_norm_kernel
from repro_torch.kernels import select_mask as select_mask_kernel
from repro_torch.kernels.channel_norm import channel_norms_leaves
from repro_torch.kernels.select_mask import select_mask_leaves
from repro_torch.params import tree_leaves, tree_unflatten
from repro_torch.sharding.rules import like, local_shard

# Materialise T exactly up to this many channels; sample beyond it.
MAX_MATERIALIZED = 1 << 22
NUM_SAMPLES = 1 << 16        # channels the sampled path draws a client


def layer_scores(grads: Sequence[dict], normalize: bool = False,
                 neuron_masks: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
    """Per-layer neuron scores s_l (fp32, shape (m_l,), or (S, m_l) for a
    slot-stacked delta) for an MLP delta.

    The weight part is the column squared norm from the channel-norm
    kernel, one launch for every weight matrix (and every slot); the bias
    square is added after it, as in the reference.
    ``normalize`` divides by the layer mean; ``neuron_masks`` scores
    pruned neurons ``-inf`` (mask-mode SCBFwP).
    """
    scores = []
    norms = channel_norms_leaves([g["w"] for g in grads])
    for l, (g, (_, s)) in enumerate(zip(grads, norms)):
        if "b" in g and g["b"] is not None:
            b = g["b"].to(torch.float32)
            s = s + b * b
        m = None
        if neuron_masks is not None and l < len(neuron_masks):
            m = neuron_masks[l]
        if normalize:
            if m is None:
                mean = torch.mean(s, axis=-1, keepdim=True)
            else:
                mean = torch.sum(s * m, axis=-1, keepdim=True) / \
                    torch.clamp(torch.sum(m, axis=-1), min=1.0)
            s = s / torch.clamp(mean, min=1e-30)
        if m is not None:
            s = torch.where(m > 0, s, torch.full_like(s, float("-inf")))
        scores.append(s)
    return scores


def _interpolate(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation at fractional index ``pos`` of sorted ``vals``
    (along the last axis; ``pos`` 0-d or one a row), with the reference's
    weights: lo·(1 - frac) + hi·frac."""
    n = vals.shape[-1]

    def at(i: torch.Tensor) -> torch.Tensor:
        i = i.expand(vals.shape[:-1]).unsqueeze(-1)
        return torch.gather(vals, -1, i).squeeze(-1)

    lo = torch.clamp(torch.floor(pos), 0, n - 1).to(torch.int64)
    hi = torch.clamp(torch.ceil(pos), 0, n - 1).to(torch.int64)
    frac = pos - torch.floor(pos)
    return at(lo) * (1.0 - frac) + at(hi) * frac


def quantile(values: torch.Tensor, q: float, axis: int = -1
             ) -> torch.Tensor:
    """The q-quantile of a flat fp32 vector (of each row of a (S, n)
    matrix: ``axis`` is the reduced one, the last), linear interpolation.

    The same arithmetic as ``jnp.quantile`` (position q·(n-1) in fp32,
    weights 1-frac and frac); ``torch.quantile`` lerps with another
    rounding and refuses more than 2^24 entries.
    """
    vals = torch.sort(values.movedim(axis, -1), axis=-1).values
    # a fill, not a copy from the host: nothing waits on the device
    pos = torch.full((), q, dtype=torch.float32, device=vals.device) \
        * (vals.shape[-1] - 1)
    return _interpolate(vals, pos)


def masked_quantile(values: torch.Tensor, q: float, axis: int = -1
                    ) -> torch.Tensor:
    """q-quantile over the finite entries of a flat score vector (of each
    row; ``axis`` is the reduced one) — the ``-inf`` channels of pruned
    neurons sort to the front and are skipped."""
    vals = torch.sort(values.movedim(axis, -1), axis=-1).values
    n = vals.shape[-1]
    n_valid = torch.count_nonzero(torch.isfinite(vals), axis=-1)
    pos = (n - n_valid) + q * torch.clamp(n_valid - 1, min=0)
    return _interpolate(vals, pos.to(torch.float32))


def materialize_channel_tensor(scores: Sequence[torch.Tensor]
                               ) -> torch.Tensor:
    """The exact L-dimensional channel-norm tensor T (broadcast sum);
    slot-stacked scores (S, m_l) give (S, m_0, …, m_{L-1})."""
    L = len(scores)
    lead = list(scores[0].shape[:-1])
    t = torch.zeros(lead + [1] * L, dtype=torch.float32,
                    device=scores[0].device)
    for l, s in enumerate(scores):
        shape = lead + [1] * L
        shape[len(lead) + l] = s.shape[-1]
        t = t + s.reshape(shape)
    return t


def num_channels(scores: Sequence[torch.Tensor]) -> int:
    """Channels of one client's network: Π m_l."""
    n = 1
    for s in scores:
        n *= int(s.shape[-1])
    return n


def channel_quantile(scores: Sequence[torch.Tensor], upload_rate: float,
                     *, selection: str = "positive",
                     sample_idx: Optional[Sequence] = None,
                     generator: Optional[torch.Generator] = None,
                     num_samples: int = NUM_SAMPLES,
                     masked: bool = False) -> torch.Tensor:
    """Threshold q such that ~``upload_rate`` of channels have T > q
    (positive selection) or ~``upload_rate`` have T < q (negative).

    Exact when one client's channel tensor is small enough to
    materialise; stochastic (sampled channels) otherwise.  The sampled
    path takes ``sample_idx`` — one index vector per layer, e.g. the
    reference's draws in a parity test — or draws them on ``generator``
    (CPU): uniformly, or among finite (kept) neurons when ``masked``.
    Slot-stacked scores (S, m_l) give one threshold a slot, (S,); the
    sampled path then runs slot by slot (``sample_idx``: one list a slot).
    """
    if selection not in ("positive", "negative"):
        raise ValueError(f"selection must be positive|negative, got {selection}")
    q = (1.0 - upload_rate) if selection == "positive" else upload_rate
    lead = list(scores[0].shape[:-1])
    if num_channels(scores) <= MAX_MATERIALIZED:
        t = materialize_channel_tensor(scores).reshape(lead + [-1])
        return masked_quantile(t, q, axis=-1) if masked else \
            quantile(t, q, axis=-1)
    if lead:
        return torch.stack([channel_quantile(
            [s[k] for s in scores], upload_rate, selection=selection,
            sample_idx=None if sample_idx is None else sample_idx[k],
            generator=generator, num_samples=num_samples, masked=masked)
            for k in range(lead[0])])
    if sample_idx is None:
        if generator is None:
            raise ValueError("the sampled quantile path needs sample_idx= "
                             "or a generator")
        weights = [torch.isfinite(s).to(torch.float32).cpu()
                   for s in scores] if masked else None
        sample_idx = sample_channels([s.shape[0] for s in scores],
                                     generator, num_samples, weights)
    # the sampled channels' scores, added layer by layer (from the first
    # layer's, which is 0 + it exactly: scores are never -0.0)
    sampled = None
    for idx, s in zip(sample_idx, scores):
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.array(idx, dtype=np.int64))
        picked = s.index_select(-1, idx.to(s.device))
        sampled = picked if sampled is None else sampled + picked
    return quantile(sampled, q, axis=-1)


def sample_channels(sizes: Sequence[int], generator: torch.Generator,
                    num_samples: int = NUM_SAMPLES,
                    weights: Optional[Sequence[torch.Tensor]] = None
                    ) -> List[torch.Tensor]:
    """The sampled quantile path's draws for one client: an index vector
    a layer of ``sizes``, drawn on the (CPU) ``generator`` layer by layer
    — uniformly, or with ``weights`` (one CPU vector a layer: 1 for a
    kept neuron, 0 for a pruned one) among the kept neurons.  The fused
    round loop draws a chunk's indices with it before the chunk, in the
    order a per-round run draws them."""
    out = []
    for l, m in enumerate(sizes):
        if weights is not None:
            out.append(torch.multinomial(weights[l], num_samples,
                                         replacement=True,
                                         generator=generator))
        else:
            out.append(torch.randint(0, m, (num_samples,),
                                     generator=generator))
    return out


def max_completion(scores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ_l max_i s_l[i] — the best possible channel score (one a slot)."""
    total = torch.amax(scores[0], axis=-1)
    for s in scores[1:]:
        total = total + torch.amax(s, axis=-1)
    return total


class EdgeOperands(NamedTuple):
    """One weight matrix's edge rule: keep ``g[p, q]`` iff
    ``(row[p] + col[q]) + rest > thr`` — the operands of the select-mask
    and select-compact kernels.  Slot-stacked: g (S, M, N), row (S, M) or
    the shared (M,), col (S, N), thr and rest (S,)."""

    g: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    thr: torch.Tensor
    rest: torch.Tensor


def slot_groups(num_slots: int, num_leaves: int) -> List[Tuple[int, int]]:
    """Slot ranges [a, b) of a slot-stacked table of ``num_leaves``
    leaves, each within one launch of the select-mask and select-compact
    kernels (``MAX_SLOTS`` (leaf, slot) pairs)."""
    per = max(1, select_mask_kernel.MAX_SLOTS // max(num_leaves, 1))
    return [(a, min(num_slots, a + per)) for a in range(0, num_slots, per)]


def slot_range(ops: Sequence["EdgeOperands"], a: int, b: int
               ) -> List["EdgeOperands"]:
    """Slots [a, b) of slot-stacked edge operands (a row every slot shares
    stays shared)."""
    return [op._replace(g=op.g[a:b], col=op.col[a:b], thr=op.thr[a:b],
                        rest=op.rest[a:b],
                        row=op.row[a:b] if op.row.ndim == 2 else op.row)
            for op in ops]


def edge_operands(grads: Sequence[dict], scores: Sequence[torch.Tensor],
                  threshold: torch.Tensor) -> List[EdgeOperands]:
    """The edge rule of every weight matrix, in the reference's order of
    additions: layer 0 tests ``s_0[q] + rest`` (fed as row scores of
    zeros, since ``(0 + s) + rest`` is bitwise ``s + rest``), layer l > 0
    tests ``(s_{l-1}[p] + s_l[q]) + rest``.  Slot-stacked: every slot
    shares layer 0's zero row scores."""
    maxes = [torch.amax(s, axis=-1) for s in scores]
    total_max = max_completion(scores)
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=scores[0].device)
    ops = []
    for l, g in enumerate(grads):
        w = g["w"]
        if l == 0:
            row = torch.zeros((w.shape[-2],), dtype=torch.float32,
                              device=w.device)
            ops.append(EdgeOperands(w, row, scores[0], thr,
                                    total_max - maxes[0]))
        else:
            ops.append(EdgeOperands(w, scores[l - 1], scores[l], thr,
                                    total_max - maxes[l - 1] - maxes[l]))
    return ops


def apply_channel_mask(grads: Sequence[dict], scores: Sequence[torch.Tensor],
                       threshold: torch.Tensor) -> Tuple[list, list]:
    """Mask an MLP delta to the selected channels with the exact edge rule.

    Returns (masked_grads, per_layer_bool_masks).
    """
    return mask_by_operands(grads, edge_operands(grads, scores, threshold))


def mask_by_operands(grads: Sequence[dict], ops: Sequence[EdgeOperands]
                     ) -> Tuple[list, list]:
    """``apply_channel_mask`` from its ``edge_operands``: every weight mask
    comes from one launch of the select-mask kernel over the pass's leaf
    table (one a group of ``slot_groups`` for a table of more slots than
    one launch takes, the groups' outputs concatenated); bias masks are
    (m_l,) vectors (one a slot) and stay plain torch."""
    masked, masks = [], []
    groups = slot_groups(ops[0].g.shape[0], len(ops)) \
        if ops[0].g.ndim == 3 else [None]
    if len(groups) == 1:
        w_masked, w_masks, _ = select_mask_leaves(ops)
    else:
        parts = [select_mask_leaves(slot_range(ops, a, b))[:2]
                 for a, b in groups]
        w_masked = [torch.cat([p[0][l] for p in parts])
                    for l in range(len(ops))]
        w_masks = [torch.cat([p[1][l] for p in parts])
                   for l in range(len(ops))]
    for l, (g, op, mw, w_mask) in enumerate(zip(grads, ops, w_masked,
                                               w_masks)):
        # a slot's scalars against its (m_l,) scores
        rest, thr = (op.rest[..., None], op.thr[..., None]) \
            if op.col.ndim == 2 else (op.rest, op.thr)
        if l == 0:
            b_mask = op.col + rest > thr
        else:
            # bias of neuron q is on a selected channel iff its best
            # channel is
            b_mask = (torch.amax(op.row, dim=-1, keepdim=op.col.ndim == 2)
                      + op.col + rest) > thr
        mg = {"w": mw}
        has_bias = "b" in g and g["b"] is not None
        if has_bias:
            mg["b"] = torch.where(b_mask, g["b"], torch.zeros_like(g["b"]))
        masked.append(mg)
        # bias-free layers transmit no bias tensor: mask is None so the
        # upload accounting does not count phantom entries
        masks.append({"w": w_mask, "b": b_mask if has_bias else None})
    return masked, masks


# ---------------------------------------------------------------------------
# Factored channel scores for arbitrary param trees (the at-scale form the
# LM scenario uses).  Channel == output feature of each weight tensor: a
# leaf with ndim >= 2 is scored as the matrix (prod(shape[:-1]),
# shape[-1]), its score the column squared norm (K1); the mask keeps the
# columns whose score is >= the threshold (K2 with zero row scores).
# Slot-stacked trees (every leaf (K, ...): the K clients of a federated
# step) take one table a group of leaves (``leaf_tables``), one threshold
# a client.
# ---------------------------------------------------------------------------

def leaf_tables(num_leaves: int, num_slots: int = 1
                ) -> List[Tuple[int, int]]:
    """Leaf ranges [a, b) of ``num_leaves`` leaves of ``num_slots`` slots
    each, each range one launch of the channel-norm and select-mask
    kernels: at most ``MAX_LEAVES`` leaves and ``MAX_SLOTS`` (leaf, slot)
    pairs."""
    if num_slots > select_mask_kernel.MAX_SLOTS:
        raise ValueError(f"a leaf table takes at most MAX_SLOTS = "
                         f"{select_mask_kernel.MAX_SLOTS} slots, got "
                         f"{num_slots}")
    per = min(select_mask_kernel.MAX_LEAVES, channel_norm_kernel.MAX_LEAVES,
              select_mask_kernel.MAX_SLOTS // max(num_slots, 1))
    return [(a, min(num_leaves, a + per)) for a in range(0, num_leaves, per)]


def _matrices(leaf: torch.Tensor) -> torch.Tensor:
    """A slot-stacked leaf (K, ..., N) as K matrices (K, M, N)."""
    return leaf.reshape(leaf.shape[0], -1, leaf.shape[-1])


def _score_tables(leaves: Sequence[torch.Tensor],
                  scored: Sequence[int]) -> List[List[int]]:
    """The launches of a slot-stacked tree's scored leaves (indices into
    ``leaves``): grouped by dtype first (a launch takes one), the groups
    in the order their first leaf comes, tree order within each, and
    each group split by ``leaf_tables``.  A tree of one dtype gives
    ``leaf_tables``'s ranges of it."""
    by_dtype: dict = {}
    for i in scored:
        by_dtype.setdefault(leaves[i].dtype, []).append(i)
    tables = []
    for group in by_dtype.values():
        slots = leaves[group[0]].shape[0]
        tables += [group[a:b] for a, b in leaf_tables(len(group), slots)]
    return tables


class ShardAxes(NamedTuple):
    """How a DTensor leaf (K, ..., N) splits: its mesh, the mesh axes that
    split its rows (any dimension but the client axis and the last) and
    the one that splits its columns (None if they are whole), and where
    its local columns start."""

    mesh: object
    rows: Tuple[str, ...]
    cols: Optional[str]
    col_start: int


def shard_axes(leaf) -> Optional[ShardAxes]:
    """A DTensor leaf's ``ShardAxes``; None for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if not isinstance(leaf, DTensor):
        return None
    mesh, last = leaf.device_mesh, leaf.ndim - 1
    rows, cols = [], None
    for name, p in zip(mesh.mesh_dim_names, leaf.placements):
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("the client axis of a gradient never splits")
            if p.dim == last:
                cols = name
            else:
                rows.append(name)
        elif not p.is_replicate():
            raise ValueError(f"a gradient leaf placed {leaf.placements}: "
                             "reduce its partial sums first")
    _, offset = compute_local_shape_and_global_offset(
        leaf.shape, mesh, leaf.placements)
    return ShardAxes(mesh, tuple(rows), cols, int(offset[last]))


def factored_scores_slots(grads_k) -> Tuple[list, list]:
    """(leaves, scores) of a slot-stacked tree: every leaf (K, ...); a leaf
    whose client part has ndim >= 2 gets its fp32 channel scores (K, N)
    from the channel-norm kernel (one launch a leaf table of one dtype,
    ``_score_tables``), the others ``None`` (always uploaded).  A DTensor
    leaf's launch takes its local shard; its whole (K, N) scores are
    then summed and gathered over the mesh (module docstring)."""
    leaves = tree_leaves(grads_k)
    scores: List[Optional[torch.Tensor]] = [None] * len(leaves)
    idx = [i for i, leaf in enumerate(leaves) if leaf.ndim >= 3]
    for table in _score_tables(leaves, idx):
        norms = channel_norms_leaves([_matrices(local_shard(leaves[i]))
                                      for i in table])
        for i, (_, col) in zip(table, norms):
            ax = shard_axes(leaves[i])
            if ax is not None:
                col = collectives.shard_sum(col, ax.mesh, ax.rows)
                col = collectives.shard_gather(
                    col, ax.mesh, () if ax.cols is None else (ax.cols,))
            scores[i] = col
    return leaves, scores


def factored_scores(grads) -> Tuple[list, list]:
    """Per-tensor output-channel scores for any gradient tree.

    Returns (leaves, scores): for every leaf with ndim >= 2, the fp32
    squared norm over all axes except the last (the output-feature axis);
    ``None`` for the others (always uploaded — the norm/bias vectors).
    """
    leaves = tree_leaves(grads)
    _, scores = factored_scores_slots([leaf[None] for leaf in leaves])
    return leaves, [None if s is None else s[0] for s in scores]


def factored_threshold(scores: Sequence, upload_rate: float,
                       selection: str = "positive") -> torch.Tensor:
    """Global α-quantile across every tensor's channel-score pool (one a
    slot for slot-stacked scores (K, N)), with ``jnp.quantile``'s
    arithmetic (``quantile``)."""
    pool = [s for s in scores if s is not None]
    if upload_rate >= 1.0 or not pool:
        # upload everything (and with no >= 2-D leaf, nothing to rank)
        lead = pool[0].shape[:-1] if pool else ()
        return torch.full(lead, float("-inf"), dtype=torch.float32,
                          device=pool[0].device if pool else None)
    q = (1.0 - upload_rate) if selection == "positive" else upload_rate
    return quantile(torch.cat(pool, axis=-1), q, axis=-1)


def factored_mask_slots(leaves: Sequence[torch.Tensor],
                        scores: Sequence[Optional[torch.Tensor]],
                        threshold: torch.Tensor, in_place: bool = False
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Mask slot-stacked leaves (K, ...) to the channels whose score is
    ``>= threshold`` (0-d, or one a slot); returns (masked leaves,
    uploaded fraction (K,)).  ``in_place`` writes each scored leaf's
    masked values over the leaf itself (the federated step's gradients,
    which nothing reads unmasked after).

    One select-mask launch a leaf table of one dtype (``_score_tables``),
    with zero row scores shared by every slot and ``rest = 0``: the
    kernel tests ``(0 + s) + 0 > t``,
    which is ``s > t`` exactly, so ``t`` is the float just below the
    threshold and ``s > t`` holds exactly when ``s >= threshold`` (ties
    keep their channels, as in the reference; a -inf threshold keeps
    every channel).  The fraction is the reference's: kept entries over
    all entries, summed in fp32 leaf by leaf in tree order.
    """
    masked = list(leaves)
    kept_of = {}
    idx = [i for i, s in enumerate(scores) if s is not None]
    if idx:
        local = {i: _matrices(local_shard(leaves[i])) for i in idx}
        axes = {i: shard_axes(leaves[i]) for i in idx}
        dev = local[idx[0]].device
        thr = torch.as_tensor(threshold, dtype=torch.float32, device=dev)
        below = torch.nextafter(thr, torch.full_like(thr, float("-inf")))
        zeros = torch.zeros(max(g.shape[1] for g in local.values()),
                            dtype=torch.float32, device=dev)
        rest = torch.zeros((), dtype=torch.float32, device=dev)
        slots = leaves[idx[0]].shape[0]

        def cols(i):
            """Leaf i's scores of its local columns."""
            ax, n = axes[i], local[i].shape[-1]
            return scores[i] if ax is None or n == scores[i].shape[-1] \
                else scores[i][..., ax.col_start:ax.col_start + n] \
                .contiguous()
        for group in _score_tables(leaves, idx):
            table = [(local[i], zeros[:local[i].shape[1]], cols(i), below,
                      rest) for i in group]
            outs, _, counts = select_mask_leaves(
                table, masks=False,
                out=[t[0] for t in table] if in_place else None)
            counts = counts.view(len(group), slots)
            for j, i in enumerate(group):
                masked[i] = like(outs[j], leaves[i])
                ax = axes[i]
                kept_of[i] = counts[j] if ax is None else \
                    collectives.shard_sum(
                        counts[j].to(torch.int64), ax.mesh,
                        ax.rows + (() if ax.cols is None else (ax.cols,)))
    slots, dev = leaves[0].shape[0], leaves[0].device
    kept = torch.zeros(slots, dtype=torch.float32, device=dev)
    total = 0
    for i, leaf in enumerate(leaves):
        size = leaf.numel() // slots
        kept = kept + (kept_of[i].to(torch.float32) if i in kept_of else
                       torch.full((), size, dtype=torch.float32, device=dev))
        total += size
    frac = kept / torch.full((), float(total), dtype=torch.float32,
                             device=dev)
    return masked, frac


def apply_factored_mask_slots(grads_k, upload_rate: float,
                              selection: str = "positive",
                              in_place: bool = False):
    """``apply_factored_mask`` of K clients at once: every leaf of
    ``grads_k`` is (K, ...); one channel-norm and one select-mask launch a
    leaf table (``in_place``: the scored leaves masked over themselves).
    Returns (masked tree, uploaded fraction (K,))."""
    leaves, scores = factored_scores_slots(grads_k)
    thr = factored_threshold(scores, upload_rate, selection)
    masked, frac = factored_mask_slots(leaves, scores, thr, in_place)
    return tree_unflatten(grads_k, masked), frac


def apply_factored_mask(grads, upload_rate: float,
                        selection: str = "positive"):
    """Mask a gradient tree to its top-``upload_rate`` output channels.

    Channel scores pool globally across tensors, so busier layers upload
    more.  Returns (masked_grads, uploaded_fraction).
    """
    leaves = tree_leaves(grads)
    masked, frac = apply_factored_mask_slots(
        [leaf[None] for leaf in leaves], upload_rate, selection)
    return tree_unflatten(grads, [m[0] for m in masked]), frac[0]
