"""Server aggregation as ``ServerState``-carrying strategies (port of
``repro.fed.strategy``).

``ScbfSum``  W ← W + Σ_k ΔW̃_k, applied via ``comm.wire.apply_payloads``.
``FedAvg``   W ← Σ_k (n_k/n) W_k, the example-weighted McMahan mean.

The fused round loop keeps whole rounds on the device, so its server
step is the same two rules as reducers over the slot axis of stacked
``(B, …)`` tensors, with no wire decode: ``scbf_sum_step`` and
``fedavg_step``.  Wire encoding still happens, after the chunk, so
``comm.wire`` stays the source of the byte accounting.

The admission gate (``AdmissionPolicy``) and FedBuff come with the
cross-device slice (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.comm import wire
from repro_torch.core import server


def scbf_sum_step(params, stacked_deltas, neuron_masks=None):
    """W ← W + Σ_b ΔW̃_b over the slot axis of a ``(B, …)`` stack.

    The deltas accumulate *delta-first in slot order* into one zero fp32
    buffer a leaf, which is then added to the parameters once — the
    order of additions of ``wire.apply_payloads`` (zero-init scatter in
    client order, one add into W), which keeps the fused trajectory
    bitwise the per-round one.  Invalid slots arrive zeroed, and
    ``x + 0.0`` is ``x``, so padding and empty rounds leave W untouched.
    ``neuron_masks`` (mask-mode SCBFwP) zero the total at pruned
    coordinates (``_mask_total``), which stay bit-frozen.
    """
    total = []
    for layer_p, layer_d in zip(params, stacked_deltas):
        acc = {}
        for k, p in layer_p.items():
            a = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            d = layer_d[k]
            for b in range(d.shape[0]):
                a = a + d[b].to(torch.float32)
            acc[k] = a
        total.append(acc)
    if neuron_masks is not None:
        total = _mask_total(total, neuron_masks)
    return tuple({k: (p.to(torch.float32) + t[k]).to(p.dtype)
                  for k, p in layer_p.items()}
                 for layer_p, t in zip(params, total))


def _mask_total(total, neuron_masks):
    """Zero a summed delta at pruned coordinates: layer l's weight
    columns and bias by keep_l (its output neurons), its weight rows by
    keep_{l-1}; the output layer masks rows only.  Kept coordinates
    multiply by 1.0, which changes no bit."""
    out = []
    n = len(total)
    for l, layer in enumerate(total):
        w = layer["w"]
        if l > 0:
            w = w * neuron_masks[l - 1][:, None]
        if l < n - 1:
            w = w * neuron_masks[l][None, :]
        new = {"w": w}
        if "b" in layer:
            new["b"] = layer["b"] * neuron_masks[l] if l < n - 1 \
                else layer["b"]
        out.append(new)
    return tuple(out)


def fedavg_step(params, stacked_params, weights):
    """W ← Σ_b w_b W_b over the slot axis (McMahan example weighting).

    ``weights`` is the ``(B,)`` fp32 normalised weight vector with exact
    zeros on invalid slots; the sum runs in slot order from zero, as
    ``core.server.fedavg_update`` runs it.  A round with no valid slot
    (all weights zero) returns ``params`` unchanged.
    """
    any_valid = torch.sum(weights, axis=0) > 0
    out = []
    for layer_p, layer_s in zip(params, stacked_params):
        new = {}
        for k, p in layer_p.items():
            acc = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            x = layer_s[k]
            for b in range(x.shape[0]):
                acc = acc + x[b].to(torch.float32) * weights[b]
            new[k] = torch.where(any_valid, acc,
                                 p.to(torch.float32)).to(p.dtype)
        out.append(new)
    return tuple(out)


@dataclass
class ServerState:
    params: Any                      # current global model
    version: int = 0                 # bumps on every applied update


@dataclass
class RoundContribution:
    """Everything one round's participants handed to the server."""

    num_examples: np.ndarray                   # (P,) shard sizes
    payloads: Optional[List[wire.Payload]] = None   # sparse scbf uploads
    client_params: Optional[List[Any]] = None  # per-client full weights
    # mask-mode SCBFwP ships effective-geometry payloads; this remaps them
    # to the server's full geometry (core.pruning.expand_payloads) just
    # before they are applied
    expand: Optional[Callable[[List[wire.Payload]],
                              List[wire.Payload]]] = None


class ScbfSum:
    """The paper's server rule: sum the sparse masked deltas in place."""

    name = "scbf_sum"

    def init(self, params) -> ServerState:
        return ServerState(params=params)

    def aggregate(self, state: ServerState,
                  contrib: RoundContribution) -> ServerState:
        if not contrib.payloads:
            return state
        payloads = contrib.payloads
        if contrib.expand is not None:
            payloads = contrib.expand(payloads)
        params = wire.apply_payloads(state.params, payloads)
        return dataclasses.replace(state, params=params,
                                   version=state.version + 1)


class FedAvg:
    """Example-weighted weight averaging over the reporting cohort."""

    name = "fedavg"

    def init(self, params) -> ServerState:
        return ServerState(params=params)

    def aggregate(self, state: ServerState,
                  contrib: RoundContribution) -> ServerState:
        if not contrib.client_params:
            return state
        n = contrib.num_examples.astype(np.float64)
        params = server.fedavg_update(contrib.client_params,
                                      weights=n / n.sum())
        return dataclasses.replace(state, params=params,
                                   version=state.version + 1)


def make_strategy(method: str):
    if method == "scbf":
        return ScbfSum()
    if method == "fedavg":
        return FedAvg()
    raise ValueError(f"no strategy for method {method!r}")
