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
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import select_mask as select_mask_kernel
from repro_torch.kernels.channel_norm import channel_norms_leaves
from repro_torch.kernels.select_mask import select_mask_leaves

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
