"""Padded client cohorts — the batched engine's data layout (port of
``repro.fed.cohort``).

``pad_clients`` stacks K client shards into ``(K, n_max, d)`` tensors,
zero-padding short shards and carrying a ``(K, n_max)`` example mask so
padded rows are invisible to the loss
(``repro_torch.core.client.masked_bce_loss``).  For equal IID shards
``n_max == n_k``, the mask is all ones and the engine runs the unweighted
loss (``PaddedCohort.uniform``).

``bucket_size`` rounds the participant count P of a round up to a small
set of slot counts.  The port runs eagerly, so nothing recompiles on a
new P; the buckets are kept so that a round's slot count, and with it
what the kernels are given, is the reference's.  The fused round loop
plans a chunk of rounds into static ``(S, B)`` arrays
(``horizon_slot_plan``) and cuts a run into chunks (``fused_chunk_len``):
a captured round is replayed with one run-constant slot count B.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclass
class PaddedCohort:
    """K client shards stacked for one slot-stacked local-training pass."""

    x: torch.Tensor          # (K, n_max, d) features, zero-padded
    y: torch.Tensor          # (K, n_max) labels, zero-padded
    w: torch.Tensor          # (K, n_max) example mask: 1 real, 0 padding
    counts: np.ndarray       # (K,) real examples per client (host)

    @property
    def num_clients(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_max(self) -> int:
        return int(self.x.shape[1])

    @property
    def uniform(self) -> bool:
        """True iff no padding exists — every shard fills n_max rows; the
        engine then runs the unweighted loss, the sequential arithmetic."""
        return bool(np.all(self.counts == self.n_max))


BUCKET_POLICIES = ("pow2", "exact")


def bucket_size(num_participants: int, num_clients: int,
                policy: str = "pow2", multiple: int = 1) -> int:
    """Slot count for a round with ``num_participants`` reporters.

    ``pow2``: the next power of two, capped at the (rounded-up) client
    count; ``exact``: P itself.  Always a multiple of ``multiple``.
    """
    if policy not in BUCKET_POLICIES:
        raise ValueError(
            f"unknown bucket policy {policy!r}; one of {BUCKET_POLICIES}")
    if num_participants <= 0:
        return 0
    if num_participants > num_clients:
        raise ValueError(f"{num_participants} participants > "
                         f"{num_clients} clients")
    mult = max(1, int(multiple))

    def up(n: int) -> int:
        return -(-n // mult) * mult

    if policy == "exact":
        return up(num_participants)
    pow2 = 1 << (num_participants - 1).bit_length()
    return min(up(pow2), up(num_clients))


def horizon_slot_plan(participants: Sequence[np.ndarray], num_slots: int,
                      horizon: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static ``(S, B)`` participant-index / validity arrays for a fused
    chunk of ``horizon`` rounds with ``num_slots`` slots each.

    Row r holds round r's participant ids left-aligned; padding slots
    repeat the round's slot 0 (as the per-round engine pads).  Rounds
    beyond ``len(participants)`` and empty rounds are all-invalid: their
    outputs are zeroed by the validity mask and the carry passes through
    bitwise untouched.
    """
    if len(participants) > horizon:
        raise ValueError(f"{len(participants)} planned rounds exceed the "
                         f"fused horizon {horizon}")
    part_idx = np.zeros((horizon, num_slots), dtype=np.int32)
    valid = np.zeros((horizon, num_slots), dtype=bool)
    for r, part in enumerate(participants):
        p = np.asarray(part, dtype=np.int32)
        if p.size > num_slots:
            raise ValueError(f"round {r}: {p.size} participants exceed "
                             f"{num_slots} fused slots")
        if p.size:
            part_idx[r, :p.size] = p
            part_idx[r, p.size:] = p[0]
            valid[r, :p.size] = True
    return part_idx, valid


def fused_chunk_len(loops_left: int, fuse_rounds: int,
                    prune_active: bool) -> int:
    """Rounds in the next fused chunk: one while SCBFwP pruning is still
    removing neurons (the keep-masks change after every round, and a
    chunk's masks are one input), else ``fuse_rounds`` up to the loops
    left."""
    if loops_left < 1:
        raise ValueError(f"no loops left to chunk ({loops_left})")
    if prune_active:
        return 1
    return min(int(fuse_rounds), loops_left)


def pad_clients(clients: Sequence[Tuple[np.ndarray, np.ndarray]],
                device="cpu") -> PaddedCohort:
    """Stack ragged client shards into a rectangular padded cohort on
    ``device`` (built on the host, one copy a tensor)."""
    if not clients:
        raise ValueError("pad_clients needs at least one client shard")
    counts = np.array([c[0].shape[0] for c in clients], dtype=np.int64)
    if np.any(counts == 0):
        raise ValueError("every client shard must have >= 1 example")
    n_max = int(counts.max())
    d = int(clients[0][0].shape[1])
    K = len(clients)
    x = np.zeros((K, n_max, d), dtype=np.float32)
    y = np.zeros((K, n_max), dtype=np.float32)
    w = np.zeros((K, n_max), dtype=np.float32)
    for k, (xc, yc) in enumerate(clients):
        n = int(xc.shape[0])
        x[k, :n] = xc
        y[k, :n] = np.asarray(yc).reshape(-1)
        w[k, :n] = 1.0
    return PaddedCohort(*(torch.from_numpy(a).to(device) for a in (x, y, w)),
                        counts)
