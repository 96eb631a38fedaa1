"""Server aggregation as ``ServerState``-carrying strategies (port of
``repro.fed.strategy``).

``ScbfSum``  W ← W + Σ_k ΔW̃_k, applied via ``comm.wire.apply_payloads``.
``FedAvg``   W ← Σ_k (n_k/n) W_k, the example-weighted McMahan mean.

The admission gate (``AdmissionPolicy``) and FedBuff come with the
cross-device slice (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np

from repro_torch.comm import wire
from repro_torch.core import server


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


class ScbfSum:
    """The paper's server rule: sum the sparse masked deltas in place."""

    name = "scbf_sum"

    def init(self, params) -> ServerState:
        return ServerState(params=params)

    def aggregate(self, state: ServerState,
                  contrib: RoundContribution) -> ServerState:
        if not contrib.payloads:
            return state
        params = wire.apply_payloads(state.params, contrib.payloads)
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
