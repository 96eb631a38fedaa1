"""Cohort execution — the per-client loop (port of
``repro.fed.engine.SequentialEngine``).

For each participant: local SGD → delta → channel selection (the two
Hopper kernels) → wire encoding (host numpy) and upload accounting.  The
shards move to the device once, when the engine is built.  The batched
and fused engines are ROADMAP A9 and A10.

The engine is a pure round executor: the driver (``core.scbf``) owns the
random draws — each participant's epoch permutations arrive in
``perms`` — so the trajectory does not depend on how the engine runs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import wire
from repro_torch.config import ScbfConfig
from repro_torch.core import selection as sel
from repro_torch.core.client import client_delta, local_train_impl


class SequentialEngine:
    """The per-client Python loop."""

    name = "sequential"

    def __init__(self, clients: Sequence[Tuple[np.ndarray, np.ndarray]],
                 batch_size: int, epochs: int, device):
        self.device = torch.device(device)
        self.clients = [(torch.as_tensor(x).to(self.device),
                         torch.as_tensor(y).to(self.device))
                        for x, y in clients]
        self.counts = np.array([x.shape[0] for x, _ in clients],
                               dtype=np.int64)
        self.batch_size = batch_size
        self.epochs = epochs

    def _train(self, params, k: int, lr: float, perms):
        xc, yc = self.clients[int(k)]
        return local_train_impl(tuple(params), xc, yc, lr, perms=perms,
                                batch_size=self.batch_size,
                                epochs=self.epochs)

    def scbf_round(self, params, participants, lr: float,
                   perms: Sequence[Sequence], cfg: ScbfConfig,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[List[wire.Payload], List[sel.UploadStats]]:
        """Train, select and encode every participant; ``perms[i]`` holds
        participant i's per-epoch permutations."""
        payloads, stats = [], []
        for i, k in enumerate(participants):
            new_p = self._train(params, k, lr, perms[i])
            g = client_delta(tuple(params), new_p)
            masked, masks, _ = sel.select_gradients(
                g, cfg.upload_rate, cfg.selection,
                score_norm=cfg.score_norm, generator=generator)
            payloads.append(wire.encode(masked))
            stats.append(sel.UploadStats.from_masks(masks))
        return payloads, stats

    def fedavg_round(self, params, participants, lr: float,
                     perms: Sequence[Sequence]):
        outs = [self._train(params, k, lr, perms[i])
                for i, k in enumerate(participants)]
        return outs, self.counts[np.asarray(participants)]
