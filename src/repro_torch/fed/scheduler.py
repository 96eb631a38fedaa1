"""Round scheduling — who trains, who reports, and how stale they are
(port of ``repro.fed.scheduler``; host numpy, the reference's draws).

``sync``     sample ``sample_fraction`` of the K clients, lose some to
             dropout and (optionally) drop stragglers; every update has
             staleness 0.  With a ``SimClock`` the coin flips give way to
             deadline cuts: misses drop, or spill into the round their
             upload lands in, with clock-derived staleness.
``fedbuff``  buffered asynchronous rounds: up to ``concurrency`` clients
             train at once, each from the server version it started at;
             each tick some finish (stragglers more slowly) and report
             with staleness τ = current version − start version.

One seeded numpy Generator drives every draw, in the reference's order,
so a seed gives the reference's participation trace.  ``plan_horizon``
plans a fused chunk's sync rounds with the same draws; FedBuff plans
depend on the server version, so its horizon is 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.config import FedConfig

# ``plan_horizon`` (both schedulers) is the fused-execution planning
# API: the fused loop asks for the next H rounds up front so a whole
# chunk of rounds can run as one device program (fed.engine).  Sync
# plans never depend on the server state, so any horizon is just H
# consecutive ``plan`` calls off the same RNG — byte-identical to
# planning round by round.  FedBuff plans DO depend on the server
# version advancing between rounds, so its horizon is capped at 1.

# Per-tick completion probabilities for the fedbuff simulation: a fast
# client usually reports within ~1 tick; a straggler takes ~4, which is
# what makes staleness > 0 actually occur.
FAST_COMPLETION_PROB = 0.8
STRAGGLER_COMPLETION_PROB = 0.25


@dataclass
class RoundPlan:
    """One round's participation trace (host-side, all numpy)."""

    round_index: int
    participants: np.ndarray      # client ids whose updates arrive
    staleness: np.ndarray         # (P,) server-version lag per participant
    sampled: np.ndarray           # invited (sync) / newly started (fedbuff)
    dropped: np.ndarray           # lost to dropout this round
    stragglers: np.ndarray        # flagged slow this round
    # wall-clock fields, set only under the simulated clock
    # (fed.clock): the round deadline, each participant's upload
    # latency (0.0 for spilled arrivals — they were already in flight),
    # which sampled clients spilled past the deadline, and the quorum
    # attempt this plan belongs to (fed.faults.Resilience)
    deadline_s: Optional[float] = None
    latency_s: Optional[np.ndarray] = None
    spilled: Optional[np.ndarray] = None
    attempt: int = 0

    @property
    def num_participants(self) -> int:
        return int(self.participants.size)

    def telemetry(self) -> dict:
        """Scheduler fields of the flight recorder's ``round`` event
        (docs/OBSERVABILITY.md): cohort composition plus the
        FedBuff staleness profile (zeros under sync scheduling).  The
        deadline/latency fields appear only under the simulated clock,
        so the fault-free event schema is unchanged."""
        out = {
            "sampled": int(self.sampled.size),
            "dropped": int(self.dropped.size),
            "stragglers": int(self.stragglers.size),
            "staleness_mean": float(np.mean(self.staleness))
            if self.staleness.size else 0.0,
            "staleness_max": int(np.max(self.staleness))
            if self.staleness.size else 0,
        }
        if self.deadline_s is not None:
            out["deadline_s"] = round(float(self.deadline_s), 6)
            out["attempt"] = int(self.attempt)
            if self.latency_s is not None and self.latency_s.size:
                out["latency_mean_s"] = round(
                    float(np.mean(self.latency_s)), 6)
                out["latency_max_s"] = round(
                    float(np.max(self.latency_s)), 6)
            if self.spilled is not None:
                out["spilled"] = int(self.spilled.size)
        return out


class SyncScheduler:
    """Per-round client sampling with dropout and deadline stragglers.

    With a ``SimClock`` attached (``fed.clock``) the coin-flip
    dropout/straggler model is replaced by **deadline-based cohort
    cuts**: sampling is restricted to clients the availability trace
    says are awake, each sampled client draws a latency, the round
    deadline is the cohort's ``deadline_quantile`` latency, and misses
    either drop (flagged as stragglers) or **spill** — keep training
    past the deadline and report in the round their upload lands in,
    with real clock-derived staleness (the FedBuff buffer absorbs them;
    ``fed.strategy``).
    """

    def __init__(self, num_clients: int, cfg: FedConfig, seed: int = 0,
                 clock=None):
        if clock is not None and (cfg.dropout_rate > 0
                                  or cfg.straggler_rate > 0):
            raise ValueError(
                "the simulated clock REPLACES the coin-flip failure "
                "model: deadline cuts are the straggler model and "
                "crash/net faults (FaultConfig) are the dropout model — "
                "set dropout_rate/straggler_rate to 0 under "
                "ClockConfig.enabled")
        self.num_clients = num_clients
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.clock = clock
        # spilled uploads still in flight: client -> (start_round,
        # absolute finish time in simulated seconds)
        self.pending: Dict[int, Tuple[int, float]] = {}

    def plan(self, round_index: int, server_version: int = 0,
             attempt: int = 0) -> RoundPlan:
        if self.clock is not None:
            return self._plan_clocked(round_index, attempt)
        cfg, rng = self.cfg, self.rng
        m = self.max_participants
        sampled = np.sort(rng.choice(self.num_clients, size=m,
                                     replace=False))
        drop = rng.random(m) < cfg.dropout_rate
        strag = rng.random(m) < cfg.straggler_rate
        lost = drop | (strag if cfg.drop_stragglers
                       else np.zeros(m, dtype=bool))
        participants = sampled[~lost]
        return RoundPlan(
            round_index=round_index,
            participants=participants,
            staleness=np.zeros(participants.size, dtype=np.int64),
            sampled=sampled,
            dropped=sampled[drop],
            stragglers=sampled[strag],
            attempt=attempt)

    def _plan_clocked(self, round_index: int, attempt: int) -> RoundPlan:
        """Deadline-based cohort cut off the simulated wall-clock."""
        clock, rng = self.clock, self.rng
        ccfg = clock.cfg
        spill = ccfg.deadline_action == "spill"
        avail = clock.available(round_index, attempt)
        busy = np.zeros(self.num_clients, dtype=bool)
        if self.pending:
            busy[list(self.pending)] = True
        candidates = np.flatnonzero(avail & ~busy)
        m = min(self.max_participants, candidates.size)
        sampled = np.sort(rng.choice(candidates, size=m, replace=False)) \
            if m else np.array([], dtype=np.int64)
        lat_all = clock.latencies(round_index, attempt)
        lat = lat_all[sampled]
        deadline = clock.deadline(lat)
        miss = lat > deadline
        on_time, missed = sampled[~miss], sampled[miss]
        parts = [on_time]
        stale = [np.zeros(on_time.size, dtype=np.int64)]
        lats = [lat[~miss]]
        if spill:
            for k in missed:
                self.pending[int(k)] = (round_index,
                                        clock.now + float(lat_all[k]))
            round_end = clock.now + deadline
            arrived = sorted(k for k, (_, t) in self.pending.items()
                             if t <= round_end)
            if arrived:
                r0 = np.array([self.pending.pop(k)[0] for k in arrived],
                              dtype=np.int64)
                arrived = np.array(arrived, dtype=np.int64)
                parts.append(arrived)
                stale.append(round_index - r0)
                lats.append(np.zeros(arrived.size))
        participants = np.concatenate(parts)
        staleness = np.concatenate(stale)
        latency_s = np.concatenate(lats)
        order = np.argsort(participants, kind="stable")
        clock.advance(deadline + ccfg.round_gap_s)
        return RoundPlan(
            round_index=round_index,
            participants=participants[order],
            staleness=staleness[order],
            sampled=sampled,
            dropped=np.array([], dtype=np.int64),
            stragglers=missed,
            deadline_s=deadline,
            latency_s=latency_s[order],
            spilled=missed if spill else None,
            attempt=attempt)

    @property
    def max_participants(self) -> int:
        """Per-round cohort size m = round(sample_fraction · K), the
        single source of that formula: ``plan`` samples exactly m
        (dropout only removes), fused execution sizes its static (S, B)
        plan to it, and the DP amplification's q is m/K.
        """
        m = max(1, int(round(self.cfg.sample_fraction * self.num_clients)))
        return min(m, self.num_clients)

    def plan_horizon(self, start_round: int, horizon: int,
                     server_version: int = 0) -> List[RoundPlan]:
        """Plan the next ``horizon`` rounds in one call.

        Draws from the same RNG as per-round ``plan`` calls, so a fused
        loop and a per-round loop with the same seed see the exact
        same participation trace.
        """
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        return [self.plan(start_round + i, server_version)
                for i in range(horizon)]

    def referenced_versions(self) -> Set[int]:
        return set()                       # sync trains on the current version

    def referenced_rounds(self) -> Set[int]:
        """Start rounds some spilled upload is still training from — the
        federated loop keeps those param snapshots alive until the upload
        lands (empty without the clock, or under deadline_action='drop')."""
        return {r0 for r0, _ in self.pending.values()}


class FedBuffScheduler:
    """Buffered-async participation: concurrent clients, stale reports."""

    def __init__(self, num_clients: int, cfg: FedConfig, seed: int = 0):
        self.num_clients = num_clients
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        # client id -> (start_version, is_straggler)
        self.in_flight: Dict[int, Tuple[int, bool]] = {}

    def plan(self, round_index: int, server_version: int = 0,
             attempt: int = 0) -> RoundPlan:
        cfg, rng = self.cfg, self.rng
        # refill: start idle clients at the current server version
        idle = sorted(set(range(self.num_clients)) - set(self.in_flight))
        space = max(0, cfg.concurrency - len(self.in_flight))
        n_start = min(space, len(idle))
        started = np.sort(rng.choice(idle, size=n_start, replace=False)) \
            if n_start else np.array([], dtype=np.int64)
        for k in started:
            self.in_flight[int(k)] = (server_version,
                                      bool(rng.random() < cfg.straggler_rate))
        # drain: aborts, then completions
        done, dropped, stragglers = [], [], []
        for k, (v0, slow) in list(self.in_flight.items()):
            if slow:
                stragglers.append(k)
            if rng.random() < cfg.dropout_rate:
                dropped.append(k)
                del self.in_flight[k]
                continue
            p_done = STRAGGLER_COMPLETION_PROB if slow \
                else FAST_COMPLETION_PROB
            if rng.random() < p_done:
                done.append((k, server_version - v0))
                del self.in_flight[k]
        done.sort()
        participants = np.array([k for k, _ in done], dtype=np.int64)
        staleness = np.array([t for _, t in done], dtype=np.int64)
        return RoundPlan(
            round_index=round_index,
            participants=participants,
            staleness=staleness,
            sampled=started,
            dropped=np.array(sorted(dropped), dtype=np.int64),
            stragglers=np.array(sorted(stragglers), dtype=np.int64))

    def plan_horizon(self, start_round: int, horizon: int,
                     server_version: int = 0) -> List[RoundPlan]:
        """FedBuff plans one round at a time: each plan's staleness and
        refill depend on the server version the *previous* round's
        aggregation produced, so a multi-round horizon would silently
        fabricate staleness.  Refused rather than approximated."""
        if horizon != 1:
            raise ValueError(
                "fedbuff scheduling needs per-round server-version "
                f"feedback; plan_horizon supports horizon=1 only, got "
                f"{horizon} (fused execution must fall back to the "
                "per-round path)")
        return [self.plan(start_round, server_version)]

    def referenced_versions(self) -> Set[int]:
        """Server versions some in-flight client is still training from
        (the federated loop keeps those param snapshots alive)."""
        return {v0 for v0, _ in self.in_flight.values()}


def make_scheduler(cfg: FedConfig, num_clients: int, seed: int = 0,
                   clock=None):
    if cfg.mode == "sync":
        return SyncScheduler(num_clients, cfg, seed, clock=clock)
    if cfg.mode == "fedbuff":
        if clock is not None:
            raise ValueError(
                "the simulated clock drives deadline-based sync rounds; "
                "fedbuff already models asynchrony with its own "
                "completion process — enable at most one")
        return FedBuffScheduler(num_clients, cfg, seed)
    raise ValueError(f"unknown federation mode {cfg.mode!r}; sync|fedbuff")
