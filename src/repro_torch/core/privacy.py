"""Differential privacy on SCBF uploads (port of ``repro.core.privacy``).

Gaussian mechanism on the *masked* client delta: clip the upload to an
L2 bound S, add N(0, σ²S²) noise to the revealed entries only (masked
entries stay exactly zero — the channel mask is the paper's primary
privacy device; DP hardens what is revealed).

Accounting: Rényi DP by default — the Gaussian mechanism with noise
multiplier σ is (α, α/(2σ²))-RDP at every order α > 1, RDP composes by
addition over loops, and the total converts to (ε, δ)-DP by the
improved bound of Balle et al. 2020, minimised over a grid of orders.
The classic bound σ = sqrt(2 ln(1.25/δ)) / ε is kept, and refused
outside its ε ≤ 1 domain.  ``amplified_epsilon_for`` composes the
subsampled-Gaussian RDP bound (Mironov et al. 2019) when only a fraction
of clients takes part in a round.  The accountants are pure Python, a
copy of the reference's.

Slot-stacked deltas: ``gaussian_mechanism`` also takes leaves of shape
``(S, …)`` (``slots=True``) — S clients of a round at once, each clipped
by its own global L2 norm over all its leaves.

Noise: the mechanism takes its randomness where the reference takes its
key — ``noise``, standard normals, one tensor per leaf in
``comm.wire.flat_keys`` order (layers in order, ``"b"`` before ``"w"``
within a layer: the order JAX flattens a tuple of dicts, and so the order
in which the reference splits its key).  Parity tests inject the
reference's normals; a run draws them with ``draw_normals`` on a
``torch.Generator`` on the leaves' device, one ``torch.randn`` a leaf in
that same order.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch


def _leaves(tree: Sequence[dict]):
    """(layer, key) of every non-None leaf in JAX's flatten order."""
    return [(l, k) for l, layer in enumerate(tree)
            for k in sorted(layer) if layer[k] is not None]


def clip_tree(tree: Sequence[dict], max_norm: float, slots: bool = False):
    """Scale the tree so its global L2 norm is <= max_norm; returns
    (clipped tree, norm).  ``slots``: every leaf is ``(S, …)`` and each
    slot is clipped by its own norm (``norm`` then has shape (S,))."""
    keys = _leaves(tree)
    sq = None
    for l, k in keys:
        x = tree[l][k].to(torch.float32)
        part = torch.sum(x * x, dim=tuple(range(1, x.ndim))) if slots \
            else torch.sum(x * x)
        sq = part if sq is None else sq + part
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    out = [dict(layer) for layer in tree]
    for l, k in keys:
        x = tree[l][k]
        s = scale.reshape((-1,) + (1,) * (x.ndim - 1)) if slots else scale
        out[l][k] = (x.to(torch.float32) * s).to(x.dtype)
    return tuple(out), norm


def _check_delta(delta: float) -> None:
    """(ε, δ)-DP is vacuous outside δ ∈ (0, 1): refuse it."""
    if not 0.0 < delta < 1.0:
        raise ValueError(
            f"delta must be in (0, 1) for a meaningful DP guarantee, "
            f"got {delta} (delta >= 1 is satisfied by publishing the "
            f"raw data; delta <= 0 is unsatisfiable)")


def draw_normals(tree: Sequence[dict], generator: torch.Generator
                 ) -> List[torch.Tensor]:
    """Standard normals for ``gaussian_mechanism``: one ``torch.randn`` a
    leaf of ``tree``, shaped like it, in flatten order, on ``generator``
    (which lives on the leaves' device)."""
    return [torch.randn(tree[l][k].shape, generator=generator,
                        dtype=torch.float32, device=tree[l][k].device)
            for l, k in _leaves(tree)]


def gaussian_mechanism(tree: Sequence[dict],
                       noise: Sequence[Union[torch.Tensor, np.ndarray]],
                       noise_multiplier: float, max_norm: float, masks=None,
                       slots: bool = False) -> Tuple[dict, ...]:
    """Clip to max_norm and add N(0, (noise_multiplier·max_norm)²) to the
    revealed entries.

    ``noise``: standard normals, one array a leaf (shaped like it) in
    ``comm.wire.flat_keys`` order — the reference's key.  ``masks``
    (boolean reveal masks shaped like ``tree``) says which coordinates
    are released and carry noise — every one of them, including a
    revealed entry whose gradient is exactly zero; without ``masks`` the
    reveal set is ``leaf != 0``.  σ multiplies the normals in fp32 and
    the sum is taken in fp32, as the reference does.  ``slots``: leaves
    are ``(S, …)``, clipped slot by slot.

    Refuses σ ≤ 0 (that would release the clipped values in the clear
    under a DP-looking path: gate the call on ``dp_noise_multiplier > 0``)
    and a clip bound ≤ 0.
    """
    if noise_multiplier <= 0.0:
        raise ValueError(
            f"gaussian_mechanism called with noise_multiplier="
            f"{noise_multiplier}: zero/negative noise would release the "
            f"clipped update in the clear under a DP-looking code path. "
            f"Gate the call on dp_noise_multiplier > 0 to run without "
            f"DP, and report epsilon=inf for such runs.")
    if max_norm <= 0.0:
        raise ValueError(
            f"clip bound max_norm must be > 0, got {max_norm} — a "
            f"non-positive bound zeroes the upload or voids the "
            f"sensitivity analysis the (ε, δ) guarantee rests on")
    clipped, _ = clip_tree(tree, max_norm, slots=slots)
    keys = _leaves(clipped)
    if masks is not None and _leaves(masks) != keys:
        raise ValueError("masks structure does not match tree")
    if len(noise) != len(keys):
        raise ValueError(f"{len(noise)} noise tensors for {len(keys)} "
                         "leaves")
    sigma = noise_multiplier * max_norm
    out = [dict(layer) for layer in clipped]
    for i, (l, k) in enumerate(keys):
        leaf = clipped[l][k]
        z = noise[i] if isinstance(noise[i], torch.Tensor) else \
            torch.from_numpy(np.array(noise[i], dtype=np.float32))
        z = z.to(device=leaf.device, dtype=torch.float32)
        if z.shape != leaf.shape:
            raise ValueError(f"noise for leaf {(l, k)} has shape "
                             f"{tuple(z.shape)}, want {tuple(leaf.shape)}")
        mask = (leaf != 0) if masks is None else masks[l][k]
        out[l][k] = torch.where(mask, leaf.to(torch.float32) + z * sigma,
                                torch.zeros((), dtype=torch.float32,
                                            device=leaf.device)
                                ).to(leaf.dtype)
    return tuple(out)


# RDP order grid: dense near 1, sparse integer tail (the reference's)
RDP_ORDERS: Tuple[float, ...] = tuple(
    [1.0 + x / 10.0 for x in range(1, 100)]
    + list(range(11, 64)) + [128.0, 256.0, 512.0, 1024.0])


def gaussian_rdp(noise_multiplier: float, order: float,
                 steps: int = 1) -> float:
    """RDP ε of ``steps`` Gaussian releases at one Rényi order α:
    one release is (α, α/(2σ²))-RDP; composition adds."""
    if order <= 1.0:
        raise ValueError(f"RDP order must be > 1, got {order}")
    return steps * order / (2.0 * noise_multiplier ** 2)


def rdp_to_dp(rdp_curve, orders, delta: float) -> float:
    """An RDP curve to (ε, δ)-DP, minimised over orders (Balle et al.
    2020, Thm. 21): ε = ε_RDP(α) + log((α−1)/α) − (log δ + log α)/(α − 1).
    """
    _check_delta(delta)
    best = math.inf
    for eps_a, a in zip(rdp_curve, orders):
        if a <= 1.0:
            continue
        eps = eps_a + math.log1p(-1.0 / a) \
            - (math.log(delta) + math.log(a)) / (a - 1.0)
        best = min(best, eps)
    return max(best, 0.0)


# integer Rényi orders for the subsampled-Gaussian bound
SUBSAMPLED_ORDERS: Tuple[int, ...] = tuple(
    list(range(2, 64)) + [128, 256, 512, 1024])


def subsampled_gaussian_rdp(noise_multiplier: float, q: float, order: int,
                            steps: int = 1) -> float:
    """RDP ε of ``steps`` Poisson-subsampled Gaussian releases at one
    integer order α ≥ 2 (Mironov, Talwar & Zhang 2019, Thm. 11), in log
    space:  ε(α) = 1/(α−1) · log Σ_j C(α,j) (1−q)^{α−j} q^j
    exp(j(j−1)/(2σ²)).  q = 1 is the unamplified curve α/(2σ²)."""
    a = int(order)
    if a != order or a < 2:
        raise ValueError(f"subsampled RDP is an integer-order (>= 2) "
                         f"bound, got {order}")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate must be in [0, 1], got {q}")
    if q == 0.0:
        return 0.0
    if q == 1.0:
        return gaussian_rdp(noise_multiplier, float(a), steps)
    s2 = noise_multiplier ** 2
    log_terms = []
    for j in range(a + 1):
        lt = (math.lgamma(a + 1) - math.lgamma(j + 1)
              - math.lgamma(a - j + 1)
              + (a - j) * math.log1p(-q)
              + j * math.log(q)
              + j * (j - 1) / (2.0 * s2))
        log_terms.append(lt)
    m = max(log_terms)
    lse = m + math.log(sum(math.exp(t - m) for t in log_terms))
    return steps * lse / (a - 1)


def amplified_epsilon_for(noise_multiplier: float, q: float,
                          delta: float = 1e-5, rounds: int = 1) -> float:
    """Cumulative ε of ``rounds`` subsampled Gaussian releases: the
    subsampled RDP curve composed over rounds, converted once.  q ≥ 1
    falls back to ``epsilon_for``."""
    _check_delta(delta)
    if noise_multiplier <= 0:
        return math.inf
    if rounds <= 0:
        return 0.0
    if q >= 1.0:
        return epsilon_for(noise_multiplier, delta, loops=rounds)
    curve = [subsampled_gaussian_rdp(noise_multiplier, q, a, rounds)
             for a in SUBSAMPLED_ORDERS]
    return rdp_to_dp(curve, [float(a) for a in SUBSAMPLED_ORDERS], delta)


def epsilon_for(noise_multiplier: float, delta: float = 1e-5,
                loops: int = 1, accountant: str = "rdp") -> float:
    """Cumulative ε of ``loops`` Gaussian releases.  ``rdp``: compose on
    the RDP curve, convert once.  ``classic``: linear composition of
    σ = sqrt(2 ln(1.25/δ))/ε, refused where the per-release ε > 1.
    σ ≤ 0 reports ε = ∞."""
    _check_delta(delta)
    if noise_multiplier <= 0:
        return math.inf
    if loops <= 0:
        return 0.0
    if accountant == "rdp":
        curve = [gaussian_rdp(noise_multiplier, a, loops)
                 for a in RDP_ORDERS]
        return rdp_to_dp(curve, RDP_ORDERS, delta)
    if accountant == "classic":
        eps_loop = math.sqrt(2.0 * math.log(1.25 / delta)) / noise_multiplier
        if eps_loop > 1.0:
            raise ValueError(
                f"classic Gaussian bound needs per-release eps <= 1, got "
                f"{eps_loop:.3f} (noise_multiplier={noise_multiplier}); "
                "use accountant='rdp'")
        return eps_loop * loops
    raise ValueError(f"unknown accountant {accountant!r}; rdp|classic")


def sigma_for(epsilon: float, delta: float = 1e-5, loops: int = 1,
              accountant: str = "rdp") -> float:
    """Noise multiplier reaching cumulative (ε, δ) over ``loops``: RDP by
    bisection, classic in closed form within its ε ≤ 1 domain."""
    _check_delta(delta)
    if epsilon <= 0:
        raise ValueError(f"epsilon must be > 0, got {epsilon}")
    if accountant == "classic":
        eps_loop = epsilon / loops
        if eps_loop > 1.0:
            raise ValueError(
                f"classic Gaussian bound is only valid for per-release "
                f"eps <= 1, got {eps_loop:.3f}; use accountant='rdp'")
        return math.sqrt(2.0 * math.log(1.25 / delta)) / eps_loop
    if accountant != "rdp":
        raise ValueError(f"unknown accountant {accountant!r}; rdp|classic")
    lo, hi = 1e-6, 1.0
    while epsilon_for(hi, delta, loops) > epsilon:
        hi *= 2.0
        if hi > 1e12:
            raise ValueError("no noise multiplier reaches the target eps")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if epsilon_for(mid, delta, loops) > epsilon:
            lo = mid
        else:
            hi = mid
    return hi
