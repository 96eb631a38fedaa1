"""Sync round scheduling — who trains and who reports (numpy copy of
``repro.fed.scheduler``'s ``SyncScheduler`` without the simulated clock).

Each round samples ``sample_fraction`` of the K clients, loses some to
dropout and (optionally) drops stragglers that miss the deadline.  One
seeded numpy Generator drives every draw, in the reference's order, so a
seed gives the reference's participation trace.  The clock and FedBuff
scheduling come with ROADMAP A11.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.config import FedConfig


@dataclass
class RoundPlan:
    """One round's participation trace (host-side, all numpy)."""

    round_index: int
    participants: np.ndarray      # client ids whose updates arrive
    staleness: np.ndarray         # (P,) server-version lag per participant
    sampled: np.ndarray           # invited
    dropped: np.ndarray           # lost to dropout this round
    stragglers: np.ndarray        # flagged slow this round

    @property
    def num_participants(self) -> int:
        return int(self.participants.size)


class SyncScheduler:
    """Per-round client sampling with dropout and deadline stragglers."""

    def __init__(self, num_clients: int, cfg: FedConfig, seed: int = 0):
        self.num_clients = num_clients
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def plan(self, round_index: int) -> RoundPlan:
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
            stragglers=sampled[strag])

    @property
    def max_participants(self) -> int:
        """Per-round cohort size m = round(sample_fraction · K)."""
        m = max(1, int(round(self.cfg.sample_fraction * self.num_clients)))
        return min(m, self.num_clients)
