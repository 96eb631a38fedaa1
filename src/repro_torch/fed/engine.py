"""Cohort execution engines (port of ``repro.fed.engine``).

``BatchedEngine`` (the default, as in the reference) runs the P
participants of a round as one slot-stacked pass: the shards live on the
device as a padded ``(K, n_max, d)`` cohort (``fed.cohort``); a round
gathers its participants, pads them up to a bucket of B slots by
repeating slot 0 (``_pad_slots``), and runs

    local SGD → delta → channel selection → (DP noise) → validity zeroing

on ``(B, …)`` tensors — one SGD step a batch for every slot at once
(``core.client.local_train_slots``), one channel-norm and one
select-mask launch for the whole round, and one count launch and at
most one scatter launch of the select-compact kernel to encode every
participant's upload (``comm.wire.encode_round``).  Padded slots hold
slot 0's shard and permutations but take no SGD step (their loss is
masked by validity), carry no DP noise, are zeroed with
``torch.where(valid, …)``, and are never encoded: only slots
``[:p_count]`` leave the engine.

``SequentialEngine`` keeps the per-client loop (one client's pass a
launch of each kernel).  At full participation on equal shards the two
engines train the same arithmetic (the batched products are batched
GEMMs, which may round differently from one GEMM a client); on ragged
shards the batched engine permutes and batches the padded shard, as the
reference's does, so the two engines run different trainings there
(docs/FED_ENGINE.md §Caveats).

Mask-mode SCBFwP: ``nmasks`` (the device keep-masks) reach local
training and selection, and ``keep`` (the keep sets, while the model is
not yet compacted) slices every upload to the effective geometry on the
device before it is encoded and counted — after DP, as in the reference.

DP (``ScbfConfig.dp_noise_multiplier > 0``): the masked delta of each
participant is clipped and noised on its reveal masks
(``core.privacy.gaussian_mechanism``), and the encoder compacts the
noised leaves.  ``noise`` injects standard normals (a list a
participant of one array a leaf, in ``comm.wire.flat_keys`` order);
without it they are drawn on ``dp_generator`` (a generator on the run's
device): the sequential engine draws each participant's leaves in turn,
the batched engine one ``(P, *leaf)`` tensor a leaf a round.

Both engines are pure round executors: ``core.scbf.run_federated`` owns
the random draws — each participant's epoch permutations arrive in
``perms`` — so the trajectory does not depend on how the engine runs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import wire
from repro_torch.config import ScbfConfig
from repro_torch.core import privacy
from repro_torch.core import selection as sel
from repro_torch.core.channels import EdgeOperands
from repro_torch.core.client import (client_delta, local_train_impl,
                                     local_train_slots)
from repro_torch.core.pruning import index_tensors
from repro_torch.fed.cohort import PaddedCohort, bucket_size, pad_clients


def _reveal_masks(masked, masks):
    """Boolean reveal masks shaped exactly like the masked delta: one a
    transmitted leaf, so DP noise lands on every revealed coordinate,
    including revealed entries whose gradient is exactly zero."""
    return tuple({k: layer_masks[k] for k in layer_delta}
                 for layer_delta, layer_masks in zip(masked, masks))


def _compact_layers(layers, keep: Sequence[torch.Tensor]):
    """Effective-geometry slicing of one client's (or a slot-stacked
    round's) layer dicts on the device (mask-mode emission): ``keep[l]``
    indexes the kept neurons of hidden layer l, so the result is what
    ``pruning.apply_structure`` would give.  ``None`` leaves (bias-free
    masks) pass through."""
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
                    vv = vv.index_select(-2, prev)
                if l < last:
                    vv = vv.index_select(-1, keep[l])
            elif l < last:
                vv = vv.index_select(-1, keep[l])
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
            g = g.index_select(-2, keep[l - 1])
            row = row.index_select(-1, keep[l - 1])
        if l < last:
            g = g.index_select(-1, keep[l])
            col = col.index_select(-1, keep[l])
        out.append(op._replace(g=g, row=row, col=col))
    return out


def _noised_operands(ops: Sequence[EdgeOperands], masked
                     ) -> List[EdgeOperands]:
    """Under DP the encoder compacts the noised leaves: g becomes the
    mechanism's output (zero off the reveal masks), the rule unchanged."""
    return [op._replace(g=masked[l]["w"]) for l, op in enumerate(ops)]


def _pad_slots(t: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Pad axis 0 up to ``num_slots`` by repeating slot 0: padded slots
    hold a real shard (finite values), take no step, and everything they
    produce is zeroed by the validity mask and dropped before encoding."""
    p = t.shape[0]
    if num_slots == p:
        return t
    return torch.cat([t, t[:1].expand(num_slots - p, *t.shape[1:])])


def _stack_perms(perms: Sequence[Sequence], device) -> torch.Tensor:
    """(P, epochs, n) int64 on ``device`` from per-participant lists of
    per-epoch permutations (numpy arrays or tensors)."""
    rows = [torch.stack([p.to(torch.int64) if isinstance(p, torch.Tensor)
                         else torch.from_numpy(np.array(p, dtype=np.int64))
                         for p in row]) for row in perms]
    return torch.stack(rows).to(device)


class SequentialEngine:
    """The per-client Python loop."""

    name = "sequential"

    def __init__(self, clients: Sequence[Tuple[np.ndarray, np.ndarray]],
                 batch_size: int, epochs: int, device, bucket: str = "pow2",
                 pods: int = 1):
        self.device = torch.device(device)
        self.clients = [(torch.as_tensor(x).to(self.device),
                         torch.as_tensor(y).to(self.device))
                        for x, y in clients]
        self.counts = np.array([x.shape[0] for x, _ in clients],
                               dtype=np.int64)
        self.batch_size = batch_size
        self.epochs = epochs

    def perm_length(self, k: int) -> int:
        """The length of client k's epoch permutations: its shard."""
        return int(self.counts[int(k)])

    def _train(self, params, k: int, lr: float, perms, nmasks=None):
        xc, yc = self.clients[int(k)]
        return local_train_impl(tuple(params), xc, yc, lr, perms=perms,
                                batch_size=self.batch_size,
                                epochs=self.epochs, neuron_masks=nmasks)

    def scbf_round(self, params, participants, lr: float,
                   perms: Sequence[Sequence], cfg: ScbfConfig,
                   generator: Optional[torch.Generator] = None,
                   nmasks=None, keep=None, noise=None,
                   dp_generator: Optional[torch.Generator] = None
                   ) -> Tuple[List[wire.Payload], List[sel.UploadStats]]:
        """Train, select, (noise) and encode every participant; ``perms[i]``
        holds participant i's per-epoch permutations, ``noise[i]`` its DP
        normals.  ``nmasks``/``keep``: mask-mode SCBFwP (see the module
        docstring)."""
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
            if cfg.dp_noise_multiplier > 0.0:
                z = noise[i] if noise is not None else \
                    privacy.draw_normals(masked, dp_generator)
                masked = privacy.gaussian_mechanism(
                    tuple(masked), z, cfg.dp_noise_multiplier,
                    cfg.dp_clip_norm, masks=_reveal_masks(masked, masks))
                ops = _noised_operands(ops, masked)
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


class BatchedEngine:
    """Slot-stacked bucketed-cohort execution: one pass a round (see the
    module docstring).  ``bucket`` picks the participant padding
    (``fed.cohort.bucket_size``); pod sharding is ROADMAP A15."""

    name = "batched"

    def __init__(self, clients: Sequence[Tuple[np.ndarray, np.ndarray]],
                 batch_size: int, epochs: int, device, bucket: str = "pow2",
                 pods: int = 1):
        if int(pods) != 1:
            raise NotImplementedError("pod sharding is ROADMAP A15; not "
                                      "ported yet")
        bucket_size(1, 1, bucket)         # refuse an unknown policy now
        self.device = torch.device(device)
        self.cohort: PaddedCohort = pad_clients(clients, self.device)
        self.counts = self.cohort.counts
        self.batch_size = batch_size
        self.epochs = epochs
        self.bucket = bucket

    @property
    def num_clients(self) -> int:
        return self.cohort.num_clients

    def perm_length(self, k: int) -> int:
        """The length of every epoch permutation: the padded shard,
        n_max, which the masked loss batches (the reference permutes
        ``x.shape[0]`` of the padded shard)."""
        return self.cohort.n_max

    def _gather(self, participants):
        part = np.asarray(participants)
        c = self.cohort
        if part.size == self.num_clients and \
                np.array_equal(part, np.arange(self.num_clients)):
            return c.x, c.y, c.w
        idx = torch.as_tensor(part, dtype=torch.int64, device=self.device)
        return (c.x.index_select(0, idx), c.y.index_select(0, idx),
                c.w.index_select(0, idx))

    def _bucketed_inputs(self, participants, slot_tensors):
        """Pad per-slot tensors up to the bucket by repeating slot 0;
        returns (B, tensors, valid)."""
        p_count = len(participants)
        b = bucket_size(p_count, self.num_clients, self.bucket)
        valid = torch.arange(b, device=self.device) < p_count
        return b, [_pad_slots(t, b) for t in slot_tensors], valid

    def _train(self, params, participants, lr, perms, nmasks=None):
        """(B, trained slot-stacked params, the params they started from,
        valid)."""
        xs, ys, ws = self._gather(participants)
        b, (xs, ys, ws, pm), valid = self._bucketed_inputs(
            participants, (xs, ys, ws, _stack_perms(perms, self.device)))
        start = tuple({k: v.unsqueeze(0).expand(b, *v.shape)
                       for k, v in layer.items()} for layer in params)
        new_p = local_train_slots(
            start, xs, ys, lr, pm, w=None if self.cohort.uniform else ws,
            valid=valid, batch_size=self.batch_size, epochs=self.epochs,
            neuron_masks=nmasks)
        return b, new_p, start, valid

    def _round_noise(self, masked, noise, p_count: int, b: int,
                     generator: Optional[torch.Generator]):
        """One (B, *leaf) normal tensor a leaf, in ``wire.flat_keys``
        order: the participants' injected normals, or one ``torch.randn``
        of (P, *leaf) a leaf on ``generator``; padded slots get zeros, so
        no padded slot shares a participant's noise."""
        real = tuple({k: v[:p_count] for k, v in layer.items()}
                     for layer in masked)
        if noise is None:
            z = privacy.draw_normals(real, generator)
        else:
            z = [torch.from_numpy(np.stack([np.asarray(noise[i][j],
                                                       np.float32)
                                            for i in range(p_count)]))
                 .to(self.device) for j in range(len(noise[0]))]
        return [torch.cat([zj, zj.new_zeros((b - p_count, *zj.shape[1:]))])
                for zj in z]

    def scbf_round(self, params, participants, lr: float,
                   perms: Sequence[Sequence], cfg: ScbfConfig,
                   generator: Optional[torch.Generator] = None,
                   nmasks=None, keep=None, noise=None,
                   dp_generator: Optional[torch.Generator] = None
                   ) -> Tuple[List[wire.Payload], List[sel.UploadStats]]:
        """Masked sparse uploads for every participant, one slot-stacked
        pass: train → delta → select → DP → validity zeroing → (keep
        compaction) → one round encode.  An empty round returns
        ``([], [])`` without launching anything."""
        p_count = len(participants)
        if not p_count:
            return [], []
        b, new_p, start, valid = self._train(params, participants, lr, perms,
                                             nmasks)
        g = client_delta(start, new_p)
        masked, masks, _, ops = sel.select_gradients(
            g, cfg.upload_rate, cfg.selection, score_norm=cfg.score_norm,
            generator=generator, neuron_masks=nmasks)
        if cfg.dp_noise_multiplier > 0.0:
            z = self._round_noise(masked, noise, p_count, b, dp_generator)
            masked = privacy.gaussian_mechanism(
                tuple(masked), z, cfg.dp_noise_multiplier, cfg.dp_clip_norm,
                masks=_reveal_masks(masked, masks), slots=True)
            ops = _noised_operands(ops, masked)
        masked = tuple(
            {k: torch.where(valid.reshape((-1,) + (1,) * (t.ndim - 1)), t,
                            torch.zeros_like(t))
             for k, t in layer.items()} for layer in masked)
        masks = tuple(
            {k: (None if m is None else torch.logical_and(
                m, valid.reshape((-1,) + (1,) * (m.ndim - 1))))
             for k, m in layer.items()} for layer in masks)
        if keep is not None:
            keep_t = index_tensors(keep, self.device)
            masked = _compact_layers(masked, keep_t)
            masks = _compact_layers(masks, keep_t)
            ops = _compact_operands(ops, keep_t)
        return (wire.encode_round(masked, ops, p_count),
                sel.UploadStats.from_slot_masks(masks, p_count))

    def fedavg_round(self, params, participants, lr: float,
                     perms: Sequence[Sequence]):
        """Full-weight training, slot-stacked; returns (per-client params
        — views into the stacked output's real slots — and counts)."""
        p_count = len(participants)
        if not p_count:
            return [], self.counts[:0]
        _, new_p, _, _ = self._train(params, participants, lr, perms)
        res = [tuple({k: v[i] for k, v in layer.items()} for layer in new_p)
               for i in range(p_count)]
        return res, self.counts[np.asarray(participants)]


ENGINES = {"batched": BatchedEngine, "sequential": SequentialEngine}


def make_engine(kind: str, clients, batch_size: int, epochs: int, device,
                bucket: str = "pow2", pods: int = 1):
    if kind not in ENGINES:
        raise ValueError(f"unknown engine {kind!r}; one of {sorted(ENGINES)}")
    return ENGINES[kind](clients, batch_size, epochs, device, bucket=bucket,
                         pods=pods)
