"""On-device telemetry of the federated engines — ``MetricsCarry`` (port
of ``repro.obs.metrics``).

A round's observables (train loss, selected channels, upload bytes by
codec) are computed on the device, beside the round's own work: each
cohort slot contributes a row of a slot-stacked carry (``slot_metrics``),
``reduce_slots`` sums the slots into the round's carry, and the fused
round loop stores each round's carry into an ``(S,)`` stack inside its
captured round.  ``offload`` then brings a round's (per-round engine) or
a whole chunk's (fused loop) telemetry to the host in ONE device→host
copy: the carry is packed into one int32 buffer on the device first.

Byte accounting is ``repro_torch.comm.wire``'s: per leaf the three codec
costs (coo / bitmap / dense, in ``wire.CODECS`` order) are priced on the
nonzero count of the masked delta and the cheapest wins, ties going to
the first in ``CODECS`` order as ``min()`` does there — so the device
numbers equal the encoded payloads' bytes exactly.  Mask-mode SCBFwP
emission compacts payloads to the effective geometry;
``effective_leaf_sizes`` gives those sizes, and the round prices them
from a device input (pruned coordinates are exactly zero, so the
nonzero counts need no compaction).

Everything is int32 / fp32 work on a few scalars a leaf, and nothing
here reads a device value on the host except ``offload``: the functions
run inside a captured CUDA graph.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.comm import wire
from repro_torch.obs import trace

_ITEMSIZE = 4                      # masked deltas travel as fp32


class MetricsCarry(NamedTuple):
    """Per-round SCBF telemetry, accumulated on the device.

    Every field is a *sum over valid slots* (a padded slot contributes
    exact zeros), so an ``(S,)``-stacked carry offloads as raw per-round
    totals and ``offload`` derives the mean loss.  ``selected`` is
    ``(L,)`` — selected channels a layer; ``codec_bytes`` is ``(3,)`` in
    ``wire.CODECS`` order.  A slot-stacked carry (``slot_metrics``) has
    one more leading ``(B,)`` dimension.
    """

    loss_sum: torch.Tensor         # fp32 — Σ valid-slot train loss
    participants: torch.Tensor     # int32 — valid slots this round
    selected: torch.Tensor         # (L,) int32 — Σ selected channels
    sparse_bytes: torch.Tensor     # int32 — Σ cheapest-codec wire bytes
    codec_bytes: torch.Tensor      # (3,) int32 — bytes by winning codec


class FedAvgMetrics(NamedTuple):
    """FedAvg's carry: dense uploads have no codec or selection."""

    loss_sum: torch.Tensor         # fp32
    participants: torch.Tensor     # int32


def leaf_codec_costs(nnz: torch.Tensor, sizes) -> torch.Tensor:
    """(3, *nnz.shape) int32 codec costs, rows in ``wire.CODECS`` order.

    ``nnz``: int32 nonzero counts; ``sizes``: the leaves' sizes, an int32
    tensor on ``nnz``'s device, a sequence (made one here: not under
    capture) or a Python int.  The formulas are ``wire.coo_bytes`` /
    ``bitmap_bytes`` / ``dense_bytes``.
    """
    if not isinstance(sizes, (int, torch.Tensor)):
        sizes = torch.as_tensor(np.asarray(sizes, np.int32),
                                device=nnz.device)
    coo = nnz * (wire.INDEX_BYTES + _ITEMSIZE)
    bitmap = nnz * _ITEMSIZE + (sizes + 7) // 8
    dense = torch.zeros_like(nnz) + sizes * _ITEMSIZE
    return torch.stack([coo, bitmap, dense])


def slot_metrics(loss: torch.Tensor, masked: Sequence[dict],
                 masks: Sequence[dict], valid: torch.Tensor,
                 eff_sizes: Optional[torch.Tensor] = None) -> MetricsCarry:
    """The ``(B,)``-stacked carry of a round's B slots (every field one
    dimension up), on the device.

    ``masked`` / ``masks`` are the round's slot-stacked masked deltas and
    masks after validity zeroing (a padded slot's are zero), so the byte
    and channel counts need no gating; ``loss`` (B,) comes from training
    and is gated by ``valid`` here.  ``eff_sizes`` (n_leaves,) int32 on
    the device prices the effective geometry (mask-mode SCBFwP); None
    prices the leaves' own sizes.  Leaves in ``wire.flat_keys`` order.
    """
    keys = wire.flat_keys(masked)
    nnz = [torch.count_nonzero(masked[l][k], axis=tuple(
        range(1, masked[l][k].ndim))).to(torch.int32) for l, k in keys]
    # a leaf's size is a Python int (folded into the launches) or a 0-d
    # device tensor: no host value crosses to the device under capture
    costs = torch.stack(
        [leaf_codec_costs(n, eff_sizes[i] if eff_sizes is not None
                          else int(np.prod(masked[l][k].shape[1:])))
         for i, (n, (l, k)) in enumerate(zip(nnz, keys))], axis=-1)
    cheapest = torch.amin(costs, axis=0)            # (B, n_leaves)
    # argmin returns the first minimum: a tie goes to the first codec in
    # CODECS order, as wire.cheapest_bytes' min() does
    winner = torch.argmin(costs, axis=0)
    per_codec = torch.stack(
        [torch.sum(torch.where(winner == c, cheapest, 0), axis=-1)
         for c in range(len(wire.CODECS))], axis=-1).to(torch.int32)
    sel = []
    for layer in masks:
        b = layer.get("b")
        if b is not None:
            sel.append(torch.count_nonzero(b, axis=-1))
        else:
            # a bias-free layer: a channel is selected iff any of its
            # edges is (reduce the slot's input axis with any, not all)
            sel.append(torch.count_nonzero(torch.any(layer["w"], axis=-2),
                                           axis=-1))
    return MetricsCarry(
        loss_sum=torch.where(valid, loss, 0.0).to(torch.float32),
        participants=valid.to(torch.int32),
        selected=torch.stack(sel, axis=-1).to(torch.int32),
        sparse_bytes=torch.sum(cheapest, axis=-1).to(torch.int32),
        codec_bytes=per_codec)


def reduce_slots(slot_stacked):
    """Sum a ``(B,)``-stacked slot carry down to one round's carry, in the
    fields' dtypes (int32 sums stay int32)."""
    return type(slot_stacked)(*(torch.sum(a, axis=0).to(a.dtype)
                                for a in slot_stacked))


def fedavg_metrics(losses: torch.Tensor, valid: torch.Tensor
                   ) -> FedAvgMetrics:
    """A FedAvg round's carry from its slots' losses (B,) and validity:
    the cohort's sum over its valid slots, reduced on the device; no
    client's own loss reaches the carry (and FedAvg makes no DP claim)."""
    loss_sum = torch.sum(torch.where(valid, losses, 0.0),
                         axis=0).to(torch.float32)
    # privlint: disable=PL006
    return FedAvgMetrics(
        loss_sum=loss_sum,
        participants=torch.count_nonzero(valid, axis=0).to(torch.int32))


def effective_leaf_sizes(params: Sequence[dict],
                         keep: Optional[Sequence] = None) -> np.ndarray:
    """Host (n_leaves,) int32 — leaf sizes after emission compaction.

    The geometry of ``fed.engine._compact_layers``: hidden layer l keeps
    ``len(keep[l])`` neurons, so layer l's weight is (kept_{l-1},
    kept_l) and its bias (kept_l,), the input and output dimensions never
    compacted.  ``keep=None`` gives the full sizes.  Leaf order is the
    reference's (sorted keys: "b" before "w" a layer, as
    ``wire.flat_keys``); a ``None`` entry (bias-free layer) has no leaf.
    """
    last = len(params) - 1
    sizes: List[int] = []
    for l, layer in enumerate(params):
        shape = tuple(layer["w"].shape)
        rows = int(shape[0]) if l == 0 or keep is None else len(keep[l - 1])
        cols = int(shape[1]) if l == last or keep is None else len(keep[l])
        for k in sorted(layer.keys()):
            if layer[k] is None:
                continue
            if k == "w":
                sizes.append(rows * cols)
            elif k == "b":
                sizes.append(cols)
            else:
                sizes.append(int(np.prod(tuple(layer[k].shape))))
    return np.asarray(sizes, np.int32)


_VECTORS = ("selected", "codec_bytes")    # a vector a round


def _columns(carry):
    """(name, (…, width) tensor) of each field: a round's scalar one
    column, a vector its width."""
    return [(name, a if name in _VECTORS else a.unsqueeze(-1))
            for name, a in zip(carry._fields, carry)]


def _pack(carry) -> torch.Tensor:
    """The carry as one int32 tensor (…, columns) on its device; the fp32
    loss travels as its bits."""
    return torch.cat([(a.to(torch.float32).view(torch.int32)
                       if name == "loss_sum" else a.to(torch.int32))
                      for name, a in _columns(carry)], axis=-1)


def offload(carry, rounds: Optional[int] = None
            ) -> Union[Dict[str, Any], List[Dict[str, Any]]]:
    """THE device→host transfer of a round's or a chunk's telemetry.

    The carry is packed into one int32 buffer on the device and copied to
    the host once.  ``rounds=None`` converts one round's carry; an
    integer trims an ``(S,)``-stacked carry to its first ``rounds``
    rounds.  Returns plain-Python dicts for the event log: ``train_loss``
    is the mean a participant, ``codec_bytes`` is keyed by
    ``wire.CODECS`` name.
    """
    host = _pack(carry).cpu().numpy()
    trace.count("host_offloads")
    fields, at = {}, 0
    for name, a in _columns(carry):
        col = host[..., at:at + a.shape[-1]]
        at += a.shape[-1]
        if name == "loss_sum":
            col = np.ascontiguousarray(col).view(np.float32)
        fields[name] = col if name in _VECTORS else col[..., 0]

    def row(r: Optional[int]) -> Dict[str, Any]:
        def pick(name):
            a = np.asarray(fields[name])
            return a if r is None else a[r]

        p = int(pick("participants"))
        out: Dict[str, Any] = {
            "participants": p,
            "train_loss": float(pick("loss_sum")) / max(p, 1),
        }
        if "selected" in fields:
            out["selected"] = [int(s) for s in np.atleast_1d(
                pick("selected"))]
        if "sparse_bytes" in fields:
            out["sparse_bytes"] = int(pick("sparse_bytes"))
        if "codec_bytes" in fields:
            out["codec_bytes"] = {
                c: int(b) for c, b in zip(wire.CODECS,
                                          np.atleast_1d(pick("codec_bytes")))}
        return out

    if rounds is None:
        return row(None)
    return [row(r) for r in range(rounds)]
