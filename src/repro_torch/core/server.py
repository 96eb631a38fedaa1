"""Central-server update rules (port of ``repro.core.server``).

SCBF (paper Algorithm 1):      W <- W + Σ_k ΔW̃_k   (sum of masked deltas)
Federated Averaging (McMahan): W <- Σ_k (n_k/n) W_k (weight average)
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.comm import wire
from repro_torch.params import tree_map


def scbf_update(server_params, masked_deltas: Optional[Sequence] = None,
                *, payloads: Optional[Sequence["wire.Payload"]] = None):
    """W <- W + Σ_k ΔW̃_k (the paper sums — it does not average).

    Pass ``masked_deltas`` (dense zero-masked deltas) or ``payloads``
    (encoded uploads); the two agree because encoding is lossless.
    """
    if (masked_deltas is None) == (payloads is None):
        raise ValueError("pass exactly one of masked_deltas | payloads")
    if payloads is not None:
        return wire.apply_payloads(server_params, payloads)
    total = masked_deltas[0]
    for d in masked_deltas[1:]:
        total = tree_map(torch.add, total, d)
    return tree_map(torch.add, server_params, total)


def fedavg_update(client_params: Sequence, weights: Sequence = None):
    """W <- Σ_k w_k W_k (default: equal weights, the plain mean).

    ``weights`` are normalised client weights (n_k/n).  Accumulation is
    incremental — one running set of weights, never a K-stacked copy.
    """
    if weights is None:
        n = float(len(client_params))
        summed = client_params[0]
        for p in client_params[1:]:
            summed = tree_map(torch.add, summed, p)
        return tree_map(lambda s: s / n, summed)
    if len(weights) != len(client_params):
        raise ValueError("one weight per client required")
    w0 = float(weights[0])
    summed = tree_map(lambda x: x.to(torch.float32) * w0, client_params[0])
    for w, p in zip(weights[1:], client_params[1:]):
        wf = float(w)
        summed = tree_map(lambda s, x: s + x.to(torch.float32) * wf,
                           summed, p)
    return tree_map(lambda s, ref: s.to(ref.dtype), summed,
                     client_params[0])
