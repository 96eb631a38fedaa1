"""APoZ neuron pruning — paper §2.1 "Pruning Process" (SCBFwP).

Port of ``repro.core.pruning`` (see its docstring).  APoZ (Average
Percentage of Zeros) of a hidden neuron is the fraction of validation
examples for which its post-ReLU activation is exactly zero; each step
removes the θ (``prune_rate``) fraction of the *remaining* hidden neurons
with the highest APoZ, until θ_total of the original neurons are gone.

``reshape``  ``apply_structure`` slices the server's tensors between
             loops: later loops train and upload smaller models.
``mask``     per-layer fp32 keep-masks on the device zero pruned neurons
             in forward/backward and selection; ``Pruner`` compacts
             physically once, when the budget is spent.

The APoZ counts come from the apoz kernel (``kernels.apoz``) on CUDA;
the budget and the greedy removal are host numpy, as in the reference,
so ties break the same way.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import wire
from repro_torch.kernels.apoz import apoz_batch_fractions
from repro_torch.models import mlp_net


def apoz_scores(params: Sequence[dict], x_val, batch_size: int = 2048,
                neuron_masks=None) -> List[np.ndarray]:
    """APoZ per hidden neuron (fp32 numpy), streamed over the validation
    set in batches of ``batch_size``.

    The reference's arithmetic exactly: per batch the fp32 fraction
    (``kernels.apoz.apoz_batch_fractions``), then on the host
    Σ fraction · n in fp32 over the batches, divided by the total — ties
    decide which neurons go, so the scores must match it bitwise.
    ``x_val`` is a tensor on the params' device (``Pruner`` moves it
    there once) or an array, copied per batch.
    """
    n_val = int(x_val.shape[0])
    if n_val == 0:
        raise ValueError("APoZ pruning needs a non-empty validation set; "
                         "got 0 examples (disable pruning or provide "
                         "validation data)")
    device = params[0]["w"].device
    splits = np.cumsum(mlp_net.hidden_sizes(params))[:-1]
    totals, count = None, 0
    for start in range(0, n_val, batch_size):
        xb = torch.as_tensor(x_val[start:start + batch_size]).to(device)
        # every layer's fractions in one buffer: one copy to the host
        flat = apoz_batch_fractions(tuple(params), xb, neuron_masks)
        frac = np.split(flat.cpu().numpy(), splits)
        n = int(xb.shape[0])
        if totals is None:
            totals = [f * n for f in frac]
        else:
            totals = [t + f * n for t, f in zip(totals, frac)]
        count += n
    return [t / count for t in totals]


def _step_budget(prune_rate: float, already_pruned: int,
                 original_hidden: int, prune_total: float) -> int:
    """Neurons to remove this step: θ of the REMAINING neurons, capped so
    the cumulative removal never exceeds ``prune_total`` of the
    original count."""
    remaining = original_hidden - already_pruned
    budget = int(prune_rate * remaining)
    allow = int(prune_total * original_hidden) - already_pruned
    return max(0, min(budget, allow))


def _greedy_remove(apoz: Sequence[np.ndarray], keep: List[np.ndarray],
                   budget: int) -> List[np.ndarray]:
    """Remove up to ``budget`` currently-kept neurons, highest APoZ
    first, never emptying a layer.  Mutates and returns the boolean
    keep-masks.  Already-removed neurons rank ``-inf``; ties break by
    stable sort (earliest layer, lowest index first)."""
    flat = np.concatenate([np.where(k, np.asarray(a, np.float64), -np.inf)
                           for a, k in zip(apoz, keep)])
    owner = np.concatenate([np.full(a.shape[0], l)
                            for l, a in enumerate(apoz)])
    layer_off = np.cumsum([0] + [a.shape[0] for a in apoz])
    order = np.argsort(-flat, kind="stable")
    removed = 0
    for idx in order:
        if removed >= budget:
            break
        if not np.isfinite(flat[idx]):        # only already-removed left
            break
        l = owner[idx]
        local = idx - layer_off[l]
        if keep[l].sum() <= 1:                # never empty a layer
            continue
        keep[l][local] = False
        removed += 1
    return keep


def plan_prune(apoz: Sequence[np.ndarray], prune_rate: float,
               already_pruned: int, original_hidden: int,
               prune_total: float) -> List[np.ndarray]:
    """Indices of neurons to KEEP per hidden layer (reshape mode)."""
    budget = _step_budget(prune_rate, already_pruned, original_hidden,
                          prune_total)
    keep = [np.ones(a.shape[0], bool) for a in apoz]
    keep = _greedy_remove(apoz, keep, budget)
    return [np.where(m)[0] for m in keep]


def update_keep_masks(apoz: Sequence[np.ndarray],
                      keep_masks: Sequence[np.ndarray], prune_rate: float,
                      prune_total: float) -> List[np.ndarray]:
    """One mask-mode pruning step over run-constant geometry: the
    returned boolean masks have this step's θ-of-remaining highest-APoZ
    kept neurons switched off (the same greedy core and budget as
    ``plan_prune``)."""
    keep = [np.asarray(m, bool).copy() for m in keep_masks]
    original_hidden = sum(m.shape[0] for m in keep)
    already = original_hidden - sum(int(np.count_nonzero(m))
                                    for m in keep)
    budget = _step_budget(prune_rate, already, original_hidden, prune_total)
    return _greedy_remove(apoz, keep, budget)


def index_tensors(keep: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Keep sets as int64 index tensors on ``device`` (one copy each)."""
    return [torch.as_tensor(np.asarray(k, np.int64), device=device)
            for k in keep]


def apply_structure(params: Sequence[dict], keep: Sequence[np.ndarray]
                    ) -> Tuple[dict, ...]:
    """Slice an MLP down to the kept hidden neurons.

    ``keep[l]`` are kept output indices of hidden layer l (the output
    layer keeps all units); they become index tensors on the params'
    device once per call.
    """
    idx = index_tensors(keep, params[0]["w"].device)
    new = []
    prev: Optional[torch.Tensor] = None
    for l, layer in enumerate(params):
        w, b = layer["w"], layer["b"]
        if prev is not None:
            w = w.index_select(0, prev)
        if l < len(params) - 1:
            w = w.index_select(1, idx[l])
            b = b.index_select(0, idx[l])
            prev = idx[l]
        new.append({"w": w, "b": b})
    return tuple(new)


def hidden_sizes(params: Sequence[dict]) -> List[int]:
    """The hidden widths of an MLP's layers, as a list (the reference's
    ``core.pruning.hidden_sizes``; ``models.mlp_net``'s is a tuple)."""
    return list(mlp_net.hidden_sizes(params))


def expand_payloads(payloads: Sequence[wire.Payload],
                    keep: Sequence[np.ndarray],
                    params: Sequence[dict]) -> List[wire.Payload]:
    """Remap effective-geometry wire payloads onto the full geometry.

    Mask-mode clients ship payloads in the *effective* coordinates that
    the keep sets define; the server stores full-geometry tensors.  Each
    payload's flat indices map back to original neuron ids (w: rows
    through ``keep[l-1]``, columns through ``keep[l]``; b: through
    ``keep[l]``; the input and output layers are never remapped).
    Values are untouched, every expanded leaf becomes a coo scatter, and
    ``nbytes`` keeps the shipped (effective) size.
    """
    out = []
    last = len(params) - 1
    for p in payloads:
        layers = []
        for (l, kk), lp in zip(p.keys, p.layers):
            keep_in = keep[l - 1] if l > 0 else None
            keep_out = keep[l] if l < last else None
            full_shape = tuple(params[l][kk].shape)
            idx = lp.flat_indices()
            if kk == "w":
                r, c = idx // lp.shape[1], idx % lp.shape[1]
                if keep_in is not None:
                    r = keep_in[r]
                if keep_out is not None:
                    c = keep_out[c]
                fidx = r * full_shape[1] + c
            else:
                fidx = keep_out[idx] if keep_out is not None else idx
            layers.append(wire.LayerPayload(
                "coo", full_shape, lp.dtype, lp.nnz, lp.nbytes,
                idx=np.asarray(fidx, np.int32), bitmap=None,
                values=lp.values))
        out.append(wire.Payload(p.keys, tuple(layers)))
    return out


class Pruner:
    """SCBFwP pruning state for one federated run.

    Owns the keep bookkeeping (original-geometry indices), the per-loop
    step (APoZ → budget → removal), and — in mask mode — the device
    keep-masks plus the optional one-shot physical compaction once the
    cumulative budget is exhausted.  ``x_val`` moves to the params'
    device once, here.
    """

    def __init__(self, params, x_val, *, prune_rate: float,
                 prune_total: float, impl: str = "reshape",
                 compact: bool = True):
        if impl not in ("reshape", "mask"):
            raise ValueError(f"unknown prune_impl {impl!r}; "
                             "one of ('reshape', 'mask')")
        self.impl = impl
        self.compact_enabled = compact
        self.prune_rate = prune_rate
        self.prune_total = prune_total
        self.device = params[0]["w"].device
        self.x_val = torch.as_tensor(x_val).to(self.device)
        self._full_hidden = hidden_sizes(params)
        self.original_hidden = sum(self._full_hidden)
        self.limit = int(prune_total * self.original_hidden)
        # kept neuron ids per hidden layer, in ORIGINAL geometry
        self.keep: List[np.ndarray] = [np.arange(h)
                                       for h in self._full_hidden]
        self.masks: Optional[Tuple[torch.Tensor, ...]] = None
        if impl == "mask":
            self.masks = tuple(torch.ones((h,), dtype=torch.float32,
                                          device=self.device)
                               for h in self._full_hidden)
        self.compacted = False
        self._stalled = False

    @property
    def mask_mode(self) -> bool:
        return self.impl == "mask"

    @property
    def pruned_so_far(self) -> int:
        return self.original_hidden - sum(len(k) for k in self.keep)

    @property
    def active(self) -> bool:
        """More pruning steps to come: the cumulative budget is not spent,
        the last step made progress, and the next step's budget is not
        truncated to zero (both are permanent)."""
        if self._stalled or self.pruned_so_far >= self.limit:
            return False
        return _step_budget(self.prune_rate, self.pruned_so_far,
                            self.original_hidden, self.prune_total) > 0

    def hidden_sizes(self) -> Tuple[int, ...]:
        """Effective (kept) hidden sizes — what the records report."""
        return tuple(len(k) for k in self.keep)

    def effective_param_count(self, params) -> int:
        """Parameters of the effective model (masked or compacted)."""
        sizes = ([int(params[0]["w"].shape[0])]
                 + [len(k) for k in self.keep]
                 + [int(params[-1]["w"].shape[1])])
        return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))

    @property
    def emission_keep(self) -> Optional[List[np.ndarray]]:
        """Keep sets for wire emission, or None when shapes are already
        physical (mask-mode payloads are sliced to this geometry)."""
        if self.mask_mode and not self.compacted:
            return self.keep
        return None

    def _keep_bool(self) -> List[np.ndarray]:
        out = []
        for h, k in zip(self._full_hidden, self.keep):
            m = np.zeros(h, bool)
            m[k] = True
            out.append(m)
        return out

    def step(self, params):
        """One pruning step on the post-aggregation server params: reshape
        mode returns the sliced params (the caller adopts them); mask mode
        returns ``params`` unchanged and updates ``self.masks``."""
        if not self.active:
            return params
        before = self.pruned_so_far
        if self.mask_mode:
            apoz = apoz_scores(params, self.x_val, neuron_masks=self.masks)
            new_keep = update_keep_masks(apoz, self._keep_bool(),
                                         self.prune_rate, self.prune_total)
            self.keep = [np.where(m)[0] for m in new_keep]
            self.masks = tuple(
                torch.from_numpy(m.astype(np.float32)).to(self.device)
                for m in new_keep)
            if self.pruned_so_far == before:
                self._stalled = True      # never-empty cap: no progress
            return params
        apoz = apoz_scores(params, self.x_val)
        keep_local = plan_prune(apoz, self.prune_rate, self.pruned_so_far,
                                self.original_hidden, self.prune_total)
        # map compacted-geometry indices back to original neuron ids
        self.keep = [k_glob[k_loc]
                     for k_glob, k_loc in zip(self.keep, keep_local)]
        if self.pruned_so_far == before:
            self._stalled = True          # never-empty cap: no progress
            return params                 # identity slice: skip it
        return apply_structure(params, keep_local)

    @property
    def should_compact(self) -> bool:
        """Mask mode only: pruning is finished, something was pruned, and
        the one-shot physical compaction has not happened yet."""
        return (self.mask_mode and self.compact_enabled and not self.active
                and not self.compacted and self.pruned_so_far > 0)

    def compact(self, params):
        """One-shot physical compaction of a fully-pruned masked model;
        afterwards ``masks`` is None and every path runs the smaller
        model."""
        params = apply_structure(params, self.keep)
        self.masks = None
        self.compacted = True
        return params
