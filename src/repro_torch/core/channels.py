"""Channel-norm algebra — the paper's §2.1 "Compute Channel Norms" step.

Port of ``repro.core.channels`` (see its docstring for the derivation).
The channel norm is separable, T[i1, …, iL] = Σ_l s_l[i_l] with
s_l[i] = Σ_p G_l[p, i]² + (∂b_l[i])², so the exact α-quantile needs only
the broadcast sum of L vectors and the edge rule needs only pair sums:

    s_{l-1}[p] + s_l[q] + Σ_{j∉{l-1,l}} max_i s_j[i]  >  q_α

Two kernels carry the per-client pass: ``kernels.channel_norm`` gives the
column norms behind ``layer_scores`` and ``kernels.select_mask`` applies
the edge rule to every weight matrix, all of a pass in one launch;
``edge_operands`` hands the same rule to the upload encoder
(``comm.wire.encode_selected``).  The rest is plain torch.  All
scores are fp32 regardless of gradient dtype.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.channel_norm import channel_norms
from repro_torch.kernels.select_mask import select_mask_leaves

# Materialise T exactly up to this many channels; sample beyond it.
MAX_MATERIALIZED = 1 << 22


def layer_scores(grads: Sequence[dict], normalize: bool = False,
                 neuron_masks: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
    """Per-layer neuron scores s_l (fp32, shape (m_l,)) for an MLP delta.

    The weight part is the column squared norm from the channel-norm
    kernel; the bias square is added after it, as in the reference.
    ``normalize`` divides by the layer mean; ``neuron_masks`` scores
    pruned neurons ``-inf`` (mask-mode SCBFwP).
    """
    scores = []
    for l, g in enumerate(grads):
        _, s = channel_norms(g["w"])
        if "b" in g and g["b"] is not None:
            b = g["b"].to(torch.float32)
            s = s + b * b
        m = None
        if neuron_masks is not None and l < len(neuron_masks):
            m = neuron_masks[l]
        if normalize:
            if m is None:
                mean = torch.mean(s)
            else:
                mean = torch.sum(s * m) / torch.clamp(torch.sum(m), min=1.0)
            s = s / torch.clamp(mean, min=1e-30)
        if m is not None:
            s = torch.where(m > 0, s, torch.full_like(s, float("-inf")))
        scores.append(s)
    return scores


def _interpolate(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation at fractional index ``pos`` of sorted ``vals``,
    with the reference's weights: lo·(1 - frac) + hi·frac."""
    n = vals.shape[0]
    lo = torch.clamp(torch.floor(pos), 0, n - 1).to(torch.int64)
    hi = torch.clamp(torch.ceil(pos), 0, n - 1).to(torch.int64)
    frac = pos - torch.floor(pos)
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def quantile(values: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of a flat fp32 vector, linear interpolation.

    The same arithmetic as ``jnp.quantile`` (position q·(n-1) in fp32,
    weights 1-frac and frac); ``torch.quantile`` lerps with another
    rounding and refuses more than 2^24 entries.
    """
    vals = torch.sort(values).values
    pos = torch.tensor(q, dtype=torch.float32, device=vals.device) \
        * (vals.shape[0] - 1)
    return _interpolate(vals, pos)


def masked_quantile(values: torch.Tensor, q: float) -> torch.Tensor:
    """q-quantile over the finite entries of a flat score vector (the
    ``-inf`` channels of pruned neurons sort to the front and are
    skipped)."""
    vals = torch.sort(values).values
    n = vals.shape[0]
    n_valid = torch.count_nonzero(torch.isfinite(vals))
    pos = (n - n_valid) + q * torch.clamp(n_valid - 1, min=0)
    return _interpolate(vals, pos.to(torch.float32))


def materialize_channel_tensor(scores: Sequence[torch.Tensor]
                               ) -> torch.Tensor:
    """The exact L-dimensional channel-norm tensor T (broadcast sum)."""
    L = len(scores)
    t = torch.zeros([1] * L, dtype=torch.float32, device=scores[0].device)
    for l, s in enumerate(scores):
        shape = [1] * L
        shape[l] = s.shape[0]
        t = t + s.reshape(shape)
    return t


def num_channels(scores: Sequence[torch.Tensor]) -> int:
    n = 1
    for s in scores:
        n *= int(s.shape[0])
    return n


def channel_quantile(scores: Sequence[torch.Tensor], upload_rate: float,
                     *, selection: str = "positive",
                     sample_idx: Optional[Sequence] = None,
                     generator: Optional[torch.Generator] = None,
                     num_samples: int = 1 << 16,
                     masked: bool = False) -> torch.Tensor:
    """Threshold q such that ~``upload_rate`` of channels have T > q
    (positive selection) or ~``upload_rate`` have T < q (negative).

    Exact when the channel tensor is small enough to materialise;
    stochastic (sampled channels) otherwise.  The sampled path takes
    ``sample_idx`` — one index vector per layer, e.g. the reference's
    draws in a parity test — or draws them on ``generator`` (CPU):
    uniformly, or among finite (kept) neurons when ``masked``.
    """
    if selection not in ("positive", "negative"):
        raise ValueError(f"selection must be positive|negative, got {selection}")
    q = (1.0 - upload_rate) if selection == "positive" else upload_rate
    if num_channels(scores) <= MAX_MATERIALIZED:
        t = materialize_channel_tensor(scores).reshape(-1)
        return masked_quantile(t, q) if masked else quantile(t, q)
    if sample_idx is None:
        if generator is None:
            raise ValueError("the sampled quantile path needs sample_idx= "
                             "or a generator")
        sample_idx = []
        for s in scores:
            if masked:
                w = torch.isfinite(s).to(torch.float32).cpu()
                sample_idx.append(torch.multinomial(
                    w, num_samples, replacement=True, generator=generator))
            else:
                sample_idx.append(torch.randint(
                    0, s.shape[0], (num_samples,), generator=generator))
    device = scores[0].device
    sampled = torch.zeros((num_samples,), dtype=torch.float32, device=device)
    for idx, s in zip(sample_idx, scores):
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.array(idx, dtype=np.int64))
        sampled = sampled + s[idx.to(device)]
    return quantile(sampled, q)


def max_completion(scores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ_l max_i s_l[i] — the best possible channel score."""
    total = torch.max(scores[0])
    for s in scores[1:]:
        total = total + torch.max(s)
    return total


class EdgeOperands(NamedTuple):
    """One weight matrix's edge rule: keep ``g[p, q]`` iff
    ``(row[p] + col[q]) + rest > thr`` — the operands of the select-mask
    and select-compact kernels."""

    g: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    thr: torch.Tensor
    rest: torch.Tensor


def edge_operands(grads: Sequence[dict], scores: Sequence[torch.Tensor],
                  threshold: torch.Tensor) -> List[EdgeOperands]:
    """The edge rule of every weight matrix, in the reference's order of
    additions: layer 0 tests ``s_0[q] + rest`` (fed as row scores of
    zeros, since ``(0 + s) + rest`` is bitwise ``s + rest``), layer l > 0
    tests ``(s_{l-1}[p] + s_l[q]) + rest``."""
    maxes = [torch.max(s) for s in scores]
    total_max = max_completion(scores)
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=scores[0].device)
    ops = []
    for l, g in enumerate(grads):
        w = g["w"]
        if l == 0:
            row = torch.zeros((w.shape[0],), dtype=torch.float32,
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
    table; bias masks are (m_l,) vectors and stay plain torch."""
    masked, masks = [], []
    w_masked, w_masks, _ = select_mask_leaves(ops)
    for l, (g, op, mw, w_mask) in enumerate(zip(grads, ops, w_masked,
                                               w_masks)):
        if l == 0:
            b_mask = op.col + op.rest > op.thr
        else:
            # bias of neuron q is on a selected channel iff its best
            # channel is
            b_mask = (torch.max(op.row) + op.col + op.rest) > op.thr
        mg = {"w": mw}
        has_bias = "b" in g and g["b"] is not None
        if has_bias:
            mg["b"] = torch.where(b_mask, g["b"], torch.zeros_like(g["b"]))
        masked.append(mg)
        # bias-free layers transmit no bias tensor: mask is None so the
        # upload accounting does not count phantom entries
        masks.append({"w": w_mask, "b": b_mask if has_bias else None})
    return masked, masks
