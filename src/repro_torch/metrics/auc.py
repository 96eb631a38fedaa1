"""Exact AUC-ROC and AUC-PR in torch (sort-based, matches sklearn).

Port of ``repro.metrics.auc``.  Both metrics sort by score descending
(a *stable* sort, as ``jnp.argsort``), accumulate TP/FP and evaluate the
curve only at tie-block end points; the previous threshold point comes
from an exclusive ``cummax`` over the masked, non-decreasing coordinate.
"""
from __future__ import annotations

import torch


def _curve_points(scores: torch.Tensor, labels: torch.Tensor):
    scores = scores.reshape(-1).to(torch.float32)
    labels = labels.reshape(-1).to(torch.float32)
    order = torch.argsort(-scores, stable=True)
    s = scores[order]
    y = labels[order]
    tp = torch.cumsum(y, 0)
    fp = torch.cumsum(1.0 - y, 0)
    # threshold points: last index of each tied-score block
    is_end = torch.cat([s[:-1] != s[1:],
                        torch.ones((1,), dtype=torch.bool, device=s.device)])
    return tp, fp, is_end


def _exclusive_cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros((1,), dtype=x.dtype, device=x.device),
                      torch.cummax(x, 0).values[:-1]])


def auc_roc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Trapezoidal area under the ROC curve (tie-aware), a 0-d tensor."""
    tp, fp, is_end = _curve_points(scores, labels)
    pos = torch.clamp(tp[-1], min=1e-12)
    neg = torch.clamp(fp[-1], min=1e-12)
    tpr = tp / pos
    fpr = fp / neg
    zero = torch.zeros((), dtype=tpr.dtype, device=tpr.device)
    prev_tpr = _exclusive_cummax(torch.where(is_end, tpr, zero))
    prev_fpr = _exclusive_cummax(torch.where(is_end, fpr, zero))
    area = torch.where(is_end, (fpr - prev_fpr) * (tpr + prev_tpr) * 0.5, zero)
    return torch.sum(area)


def auc_pr(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Average precision (step-wise interpolation, sklearn-compatible)."""
    tp, fp, is_end = _curve_points(scores, labels)
    pos = torch.clamp(tp[-1], min=1e-12)
    precision = tp / torch.clamp(tp + fp, min=1e-12)
    recall = tp / pos
    zero = torch.zeros((), dtype=recall.dtype, device=recall.device)
    prev_recall = _exclusive_cummax(torch.where(is_end, recall, zero))
    ap = torch.where(is_end, (recall - prev_recall) * precision, zero)
    return torch.sum(ap)


def bce_elementwise(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Numerically-stable per-example BCE from logits (no reduction).

    At a logit of exactly 0 (an all-zero example through zero biases,
    common at the first steps) the gradient takes the reference's
    subgradients: ``jnp.maximum`` splits a tie in halves (as
    ``torch.maximum`` does; ``torch.clamp`` would pass it whole) and
    ``jnp.abs`` has slope 1 at 0 (``torch.abs`` has 0), so the slope there
    is the reference's ``-y``.
    """
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, zero) - logits * labels
            + torch.log1p(torch.exp(-abs_logits)))


def binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                         ) -> torch.Tensor:
    """Numerically-stable mean BCE from logits: the mean over the
    examples (axis 0 of the flattened batch)."""
    return torch.mean(bce_elementwise(logits.reshape(-1), labels.reshape(-1)),
                      axis=0)
