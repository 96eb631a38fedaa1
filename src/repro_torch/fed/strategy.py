"""Server aggregation as ``ServerState``-carrying strategies (port of
``repro.fed.strategy``).

``ScbfSum``  W ← W + Σ_k ΔW̃_k, applied via ``comm.wire.apply_payloads``.
``FedAvg``   W ← Σ_k (n_k/n) W_k, the example-weighted McMahan mean.
``FedBuff``  buffered async: decoded deltas weighted by (1+τ)^−γ (τ the
             staleness, γ ``staleness_exponent``) accumulate on the
             device; each time ``buffer_size`` uploads are buffered the
             server steps by ``server_lr`` × the buffer mean and bumps its
             version.

The fused round loop keeps whole rounds on the device, so its server
step is the same two rules as reducers over the slot axis of stacked
``(B, …)`` tensors, with no wire decode: ``scbf_sum_step`` and
``fedavg_step``.  Wire encoding still happens, after the chunk, so
``comm.wire`` stays the source of the byte accounting.

The admission gate (``AdmissionPolicy``, ``admit_payloads``) is the
reference's, with its precedence: malformed → checksum → duplicate →
nonfinite → norm; every rejection is a ``payload_rejected`` event and
counters of the flight recorder (``repro_torch.obs``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.comm import wire
from repro_torch.config import FedConfig, ScbfConfig
from repro_torch.core import server
from repro_torch.obs import trace as obstrace


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
    buffer_sum: Any = None           # fedbuff: Σ weighted decoded deltas
    buffer_count: int = 0            # fedbuff: uploads buffered so far
    # (client, round) nonces of every payload already past the dedup
    # gate — a replayed upload hits its nonce and is rejected
    seen_nonces: Set[Tuple[int, int]] = field(default_factory=set)


@dataclass
class RoundContribution:
    """Everything one round's participants handed to the server."""

    num_examples: np.ndarray                   # (P,) shard sizes
    staleness: np.ndarray                      # (P,) server-version lag
    payloads: Optional[List[wire.Payload]] = None   # sparse scbf uploads
    client_params: Optional[List[Any]] = None  # per-client full weights
    # client ids aligned to the lists above (telemetry on rejection)
    clients: Optional[np.ndarray] = None
    # mask-mode SCBFwP ships effective-geometry payloads whose checksums
    # seal the bytes on the wire; admission runs on those, and this
    # remaps the admitted ones to the server's full geometry
    # (core.pruning.expand_payloads) just before they are applied
    expand: Optional[Callable[[List[wire.Payload]],
                              List[wire.Payload]]] = None


@dataclass(frozen=True)
class AdmissionPolicy:
    """What the server refuses to fold into the model: structural
    validation and the checksum always; ``max_update_norm`` (0 =
    unbounded) bounds an update's L2 norm, ``norm_action`` rejecting an
    oversized update or scaling it into the bound ("clip").  A rejected
    update leaves the aggregation entirely."""

    max_update_norm: float = 0.0
    norm_action: str = "reject"

    def __post_init__(self):
        if self.norm_action not in ("reject", "clip"):
            raise ValueError(f"unknown norm_action "
                             f"{self.norm_action!r}; reject|clip")
        if self.max_update_norm < 0:
            raise ValueError(f"max_update_norm must be >= 0, got "
                             f"{self.max_update_norm}")


def _payload_finite(p: wire.Payload) -> bool:
    return all(bool(np.isfinite(np.asarray(lp.values)).all())
               for lp in p.layers)


def _payload_norm(p: wire.Payload) -> float:
    return float(np.sqrt(sum(
        float(np.sum(np.square(np.asarray(lp.values), dtype=np.float64)))
        for lp in p.layers)))


def _scale_payload(p: wire.Payload, s: float) -> wire.Payload:
    layers = tuple(dataclasses.replace(
        lp, values=(np.asarray(lp.values) * s).astype(lp.values.dtype))
        for lp in p.layers)
    return dataclasses.replace(p, layers=layers)


def _reject(p: wire.Payload, i: int, contrib: RoundContribution,
            reason: str) -> None:
    meta = p.meta
    client = meta.client_id if meta is not None else (
        int(contrib.clients[i]) if contrib.clients is not None
        and i < len(contrib.clients) else None)
    obstrace.event("payload_rejected", reason=reason, client=client,
                   round=meta.round_index if meta is not None else None)
    obstrace.count("payloads_rejected")
    obstrace.count(f"rejected_{reason}")


def admit_payloads(state: ServerState, contrib: RoundContribution,
                   policy: AdmissionPolicy
                   ) -> Tuple[List[wire.Payload], List[int]]:
    """The server's admission gate, in the reference's order: structure
    ("malformed") → checksum ("checksum") → (client, round) nonce
    ("duplicate") → nonfinite values ("nonfinite") → L2 norm ("norm",
    rejected or clipped into the bound).  Returns the admitted payloads
    (clipped where so) and their indices into ``contrib.payloads``; each
    rejection is a ``payload_rejected`` event and bumps counters.  The
    structure check is the reference's (repeated coo indices are left to
    the checksum, ``wire.validate_layer``)."""
    kept: List[wire.Payload] = []
    kept_idx: List[int] = []
    for i, p in enumerate(contrib.payloads):
        try:
            wire.validate_payload(p, unique=False)
        except wire.PayloadError:
            _reject(p, i, contrib, "malformed")
            continue
        if not wire.verify_checksum(p):
            _reject(p, i, contrib, "checksum")
            continue
        if p.meta is not None:
            nonce = p.meta.nonce
            if nonce in state.seen_nonces:
                _reject(p, i, contrib, "duplicate")
                continue
            # recorded once past dedup, even if a later gate rejects it:
            # a replay of a rejected upload is still a replay
            state.seen_nonces.add(nonce)
        if not _payload_finite(p):
            _reject(p, i, contrib, "nonfinite")
            continue
        if policy.max_update_norm > 0:
            norm = _payload_norm(p)
            if norm > policy.max_update_norm:
                if policy.norm_action == "reject":
                    _reject(p, i, contrib, "norm")
                    continue
                p = _scale_payload(p, policy.max_update_norm / norm)
                obstrace.count("payloads_clipped")
        kept.append(p)
        kept_idx.append(i)
    return kept, kept_idx


class ScbfSum:
    """The paper's server rule: sum the sparse masked deltas in place.
    With an ``AdmissionPolicy`` the payloads pass the gate first and only
    the admitted ones are applied; a round with none admitted leaves the
    state (and version) as it was."""

    name = "scbf_sum"

    def __init__(self, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy

    def init(self, params) -> ServerState:
        return ServerState(params=params)

    def aggregate(self, state: ServerState,
                  contrib: RoundContribution) -> ServerState:
        if not contrib.payloads:
            return state
        payloads = contrib.payloads
        if self.policy is not None:
            payloads, _ = admit_payloads(state, contrib, self.policy)
            if not payloads:
                return state
        if contrib.expand is not None:
            payloads = contrib.expand(payloads)
        params = wire.apply_payloads(state.params, payloads)
        return dataclasses.replace(state, params=params,
                                   version=state.version + 1)


class FedAvg:
    """Example-weighted weight averaging over the reporting cohort.  With
    a policy a nonfinite client model is rejected (dense uploads have no
    wire payload to checksum)."""

    name = "fedavg"

    def __init__(self, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy

    def init(self, params) -> ServerState:
        return ServerState(params=params)

    def aggregate(self, state: ServerState,
                  contrib: RoundContribution) -> ServerState:
        if not contrib.client_params:
            return state
        client_params = contrib.client_params
        n = contrib.num_examples.astype(np.float64)
        if self.policy is not None:
            keep = []
            for i, cp in enumerate(client_params):
                if all(bool(torch.isfinite(leaf[k]).all())
                       for leaf in cp for k in leaf):
                    keep.append(i)
                else:
                    client = int(contrib.clients[i]) \
                        if contrib.clients is not None else None
                    obstrace.event("payload_rejected", reason="nonfinite",
                                   client=client, round=None)
                    obstrace.count("payloads_rejected")
                    obstrace.count("rejected_nonfinite")
            if not keep:
                return state
            client_params = [client_params[i] for i in keep]
            n = n[keep]
        params = server.fedavg_update(client_params, weights=n / n.sum())
        return dataclasses.replace(state, params=params,
                                   version=state.version + 1)


class FedBuff:
    """Staleness-weighted buffered-async aggregation on the device."""

    name = "fedbuff"

    def __init__(self, buffer_size: int = 10,
                 staleness_exponent: float = 0.5, server_lr: float = 1.0,
                 policy: Optional[AdmissionPolicy] = None):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        self.buffer_size = buffer_size
        self.staleness_exponent = staleness_exponent
        self.server_lr = server_lr
        self.policy = policy

    def init(self, params) -> ServerState:
        return ServerState(params=params)

    def staleness_weight(self, staleness) -> float:
        """(1+τ)^−γ — a fresh upload weighs 1, stale ones less."""
        return float((1.0 + float(staleness)) ** -self.staleness_exponent)

    def aggregate(self, state: ServerState,
                  contrib: RoundContribution) -> ServerState:
        """Fold the uploads in one at a time, stepping the server each
        time the buffer reaches ``buffer_size`` (a big round can flush
        more than once; trailing uploads buffer against the new version,
        their staleness measured at plan time, as in the reference).
        Each upload is decoded onto the params' device; the buffer and
        the step are fp32 there."""
        if not contrib.payloads:
            return state
        if self.policy is not None:
            payloads, kept = admit_payloads(state, contrib, self.policy)
            staleness = np.asarray(contrib.staleness)[kept] \
                if kept else np.zeros(0, np.int64)
        else:
            payloads, staleness = contrib.payloads, contrib.staleness
            # nonfinite guard, always on: one NaN delta would poison the
            # buffered mean, and the server state with it, for good
            bad = [i for i, p in enumerate(payloads)
                   if not _payload_finite(p)]
            if bad:
                for i in bad:
                    _reject(payloads[i], i, contrib, "nonfinite")
                ok = [i for i in range(len(payloads)) if i not in set(bad)]
                payloads = [payloads[i] for i in ok]
                staleness = np.asarray(staleness)[ok]
        if contrib.expand is not None and payloads:
            payloads = contrib.expand(payloads)
        params, version = state.params, state.version
        buf, count = state.buffer_sum, state.buffer_count
        dev = params[0]["w"].device
        for payload, tau in zip(payloads, staleness):
            wgt = self.staleness_weight(tau)
            scaled = tuple({k: v.to(torch.float32) * wgt
                            for k, v in layer.items()}
                           for layer in wire.decode(payload, dev))
            buf = scaled if buf is None else tuple(
                {k: b[k] + v for k, v in s.items()}
                for b, s in zip(buf, scaled))
            count += 1
            if count >= self.buffer_size:
                step = self.server_lr / count
                params = tuple(
                    {k: (p.to(torch.float32) + step * b[k]).to(p.dtype)
                     for k, p in layer.items()}
                    for layer, b in zip(params, buf))
                version += 1
                obstrace.event("fedbuff_flush", version=version,
                               buffered=count)
                buf, count = None, 0
        return dataclasses.replace(state, params=params, version=version,
                                   buffer_sum=buf, buffer_count=count)


def make_strategy(method: str, scbf_cfg: ScbfConfig, fed_cfg: FedConfig,
                  policy: Optional[AdmissionPolicy] = None):
    """Strategy for (method, mode): FedBuff takes the sparse scbf path
    under ``mode="fedbuff"`` and under sync rounds whose deadline misses
    spill (``clock.deadline_action="spill"``): late arrivals with
    clock-derived staleness are the buffered staleness-weighted problem.
    """
    spill = (fed_cfg.mode == "sync" and fed_cfg.clock.enabled
             and fed_cfg.clock.deadline_action == "spill")
    if fed_cfg.mode == "fedbuff" or spill:
        if method != "scbf":
            # FedBuff.aggregate reads only contrib.payloads: fedavg's
            # client params would be ignored and the server never update
            raise ValueError(
                ("deadline spilling buffers" if spill
                 else "fedbuff buffers")
                + f" sparse scbf payloads; method={method!r} "
                "produces full client weights the FedBuff strategy would "
                "silently ignore")
        return FedBuff(buffer_size=fed_cfg.buffer_size,
                       staleness_exponent=fed_cfg.staleness_exponent,
                       server_lr=fed_cfg.server_lr, policy=policy)
    if method == "scbf":
        return ScbfSum(policy=policy)
    if method == "fedavg":
        return FedAvg(policy=policy)
    raise ValueError(f"no strategy for method {method!r}")
