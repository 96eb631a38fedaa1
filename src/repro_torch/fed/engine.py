"""Cohort execution — the per-client loop (port of
``repro.fed.engine.SequentialEngine``).

For each participant: local SGD → delta → channel selection (the
channel-norm and select-mask kernels) → wire encoding from the
select-compact kernel's buffers (``wire.encode_selected``) and upload
accounting.  The shards move to the device once, when the engine is
built.  The batched and fused engines are ROADMAP A9 and A10.

Mask-mode SCBFwP: ``nmasks`` (the device keep-masks) reach local
training and selection, and ``keep`` (the keep sets, while the model is
not yet compacted) slices every upload to the effective geometry on the
device before it is encoded and counted.

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
from repro_torch.core.channels import EdgeOperands
from repro_torch.core.client import client_delta, local_train_impl
from repro_torch.core.pruning import index_tensors


def _compact_layers(layers, keep: Sequence[torch.Tensor]):
    """Effective-geometry slicing of one client's layer dicts on the
    device (mask-mode emission): ``keep[l]`` indexes the kept neurons of
    hidden layer l, so the result is what ``pruning.apply_structure``
    would give.  ``None`` leaves (bias-free masks) pass through."""
    out = []
    prev = None
    last = len(layers) - 1
    for l, layer in enumerate(layers):
        new = {}
        for kk, vv in layer.items():
            if vv is None:
                new[kk] = None
                continue
            if kk == "w":
                if prev is not None:
                    vv = vv.index_select(0, prev)
                if l < last:
                    vv = vv.index_select(1, keep[l])
            elif l < last:
                vv = vv.index_select(0, keep[l])
            new[kk] = vv
        if l < last:
            prev = keep[l]
        out.append(new)
    return tuple(out)


def _compact_operands(ops: Sequence[EdgeOperands],
                      keep: Sequence[torch.Tensor]) -> List[EdgeOperands]:
    """The edge operands sliced like ``_compact_layers`` slices the
    weights: the elementwise test commutes with the slicing."""
    out = []
    last = len(ops) - 1
    for l, op in enumerate(ops):
        g, row, col = op.g, op.row, op.col
        if l > 0:
            g = g.index_select(0, keep[l - 1])
            row = row.index_select(0, keep[l - 1])
        if l < last:
            g = g.index_select(1, keep[l])
            col = col.index_select(0, keep[l])
        out.append(op._replace(g=g, row=row, col=col))
    return out


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

    def _train(self, params, k: int, lr: float, perms, nmasks=None):
        xc, yc = self.clients[int(k)]
        return local_train_impl(tuple(params), xc, yc, lr, perms=perms,
                                batch_size=self.batch_size,
                                epochs=self.epochs, neuron_masks=nmasks)

    def scbf_round(self, params, participants, lr: float,
                   perms: Sequence[Sequence], cfg: ScbfConfig,
                   generator: Optional[torch.Generator] = None,
                   nmasks=None, keep=None
                   ) -> Tuple[List[wire.Payload], List[sel.UploadStats]]:
        """Train, select and encode every participant; ``perms[i]`` holds
        participant i's per-epoch permutations.  ``nmasks``/``keep``:
        mask-mode SCBFwP (see the module docstring)."""
        keep_t = index_tensors(keep, self.device) if keep is not None \
            else None
        payloads, stats = [], []
        for i, k in enumerate(participants):
            new_p = self._train(params, k, lr, perms[i], nmasks)
            g = client_delta(tuple(params), new_p)
            masked, masks, _, ops = sel.select_gradients(
                g, cfg.upload_rate, cfg.selection,
                score_norm=cfg.score_norm, generator=generator,
                neuron_masks=nmasks)
            if keep_t is not None:
                masked = _compact_layers(masked, keep_t)
                masks = _compact_layers(masks, keep_t)
                ops = _compact_operands(ops, keep_t)
            payloads.append(wire.encode_selected(masked, ops))
            stats.append(sel.UploadStats.from_masks(masks))
        return payloads, stats

    def fedavg_round(self, params, participants, lr: float,
                     perms: Sequence[Sequence]):
        outs = [self._train(params, k, lr, perms[i])
                for i, k in enumerate(participants)]
        return outs, self.counts[np.asarray(participants)]
