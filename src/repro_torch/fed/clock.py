"""Simulated wall clock — per-client latency and diurnal availability
(port of ``repro.fed.clock``; host numpy, the reference's draws).

``SimClock`` is a pure function of ``(seed, round_index, attempt)``:

* **static traits** — each client draws a lognormal *speed* factor and a
  diurnal *phase* once, at construction;
* **per-round latency** — compute and network times are lognormal
  around the configured medians, the compute scaled by the client's
  speed, redrawn per (round, attempt) from a hashed generator
  (``np.random.default_rng([seed, tag, round, attempt])``), not a
  sequential stream, so planning a round again (a quorum retry) or
  planning rounds in another grouping (the fused loop) draws the same;
* **diurnal availability** — the probability a client answers the
  sampler oscillates over the simulated day with its phase; ``advance``
  moves the simulated ``now`` as rounds and retry backoffs use time.

The sync scheduler turns these into deadline-based cohort cuts
(``fed.scheduler``): the deadline is the cohort's ``deadline_quantile``
latency, and misses drop or spill into later rounds.  The stream tags
are the reference's, so a seed gives the reference's latencies,
availability and deadlines bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config import ClockConfig

# hashed-RNG stream tags: np.random.default_rng seeds on the full int
# sequence, so (seed, TAG, round, attempt) gives every draw site an
# independent, call-order-free stream
_TAG_TRAITS = 0xC10C
_TAG_LATENCY = 0x1A7E
_TAG_AVAIL = 0xA1A1


class SimClock:
    """Deterministic per-client latency / availability simulator."""

    def __init__(self, num_clients: int, cfg: ClockConfig, seed: int = 0):
        if not 0.0 < cfg.deadline_quantile <= 1.0:
            raise ValueError(f"deadline_quantile must be in (0, 1], got "
                             f"{cfg.deadline_quantile}")
        if cfg.deadline_action not in ("drop", "spill"):
            raise ValueError(f"unknown deadline_action "
                             f"{cfg.deadline_action!r}; drop|spill")
        if cfg.compute_med_s < 0 or cfg.net_med_s < 0:
            raise ValueError("latency medians must be >= 0")
        if not 0.0 <= cfg.diurnal_amplitude <= 1.0:
            raise ValueError(f"diurnal_amplitude must be in [0, 1], got "
                             f"{cfg.diurnal_amplitude}")
        self.num_clients = int(num_clients)
        self.cfg = cfg
        self.seed = int(seed)
        self.now = 0.0                       # simulated seconds since start
        traits = np.random.default_rng([self.seed, _TAG_TRAITS])
        # lognormal speed: >1 = slower than the median client, fixed
        # for the whole run (compute heterogeneity is a device trait)
        self.speed = np.exp(cfg.hetero_sigma
                            * traits.standard_normal(self.num_clients))
        # diurnal phase in [0, 1): the client's timezone offset
        self.phase = traits.uniform(0.0, 1.0, self.num_clients)

    def _rng(self, tag: int, round_index: int, attempt: int
             ) -> np.random.Generator:
        return np.random.default_rng(
            [self.seed, tag, int(round_index), int(attempt)])

    # ------------------------------------------------------------------
    def latencies(self, round_index: int, attempt: int = 0) -> np.ndarray:
        """(K,) seconds from round start to upload-complete, per client.

        compute ~ LogNormal(median · speed_k, compute_sigma) plus
        network ~ LogNormal(median, net_sigma): a pure function of
        (seed, round, attempt) — re-planning a round (quorum retry)
        redraws, replaying the run does not.
        """
        cfg = self.cfg
        r = self._rng(_TAG_LATENCY, round_index, attempt)
        comp = cfg.compute_med_s * self.speed * np.exp(
            cfg.compute_sigma * r.standard_normal(self.num_clients))
        net = cfg.net_med_s * np.exp(
            cfg.net_sigma * r.standard_normal(self.num_clients))
        return comp + net

    def available(self, round_index: int, attempt: int = 0) -> np.ndarray:
        """(K,) bool — who answers the sampler at simulated ``now``.

        P(available)_k = mean − amplitude · sin(2π(now/day + phase_k)),
        clipped to [0, 1]: every client sweeps through a daily low
        (offline at night) at its own phase.
        """
        cfg = self.cfg
        frac = (self.now / cfg.day_s) if cfg.day_s > 0 else 0.0
        p = cfg.availability_mean - cfg.diurnal_amplitude * np.sin(
            2.0 * np.pi * (frac + self.phase))
        p = np.clip(p, 0.0, 1.0)
        r = self._rng(_TAG_AVAIL, round_index, attempt)
        return r.random(self.num_clients) < p

    def deadline(self, cohort_latencies: np.ndarray) -> float:
        """The round deadline: the configured quantile of the cohort's
        latencies — 'the server waits for the fastest q fraction'."""
        if cohort_latencies.size == 0:
            return 0.0
        return float(np.quantile(cohort_latencies,
                                 self.cfg.deadline_quantile))

    def advance(self, seconds: float) -> None:
        """Move simulated time forward (round duration, retry backoff)."""
        self.now += max(0.0, float(seconds))
