"""Cohort execution engines (port of ``repro.fed.engine``).

``BatchedEngine`` (the default, as in the reference) runs the P
participants of a round as one slot-stacked pass: the shards live on the
device as a padded ``(K, n_max, d)`` cohort (``fed.cohort``); a round
pads its participants up to a bucket of B slots (a padded slot trains on
slot 0's shard) and runs ``_slot_pass``:

    local SGD → delta → channel selection → (DP noise) → validity zeroing

on ``(B, …)`` tensors — one SGD step a batch for every slot at once
(``core.client.local_train_slots``, gathering each slot's batches from
its cohort row), one channel-norm launch and one select-mask launch a
group of slots for the whole round (one group up to 1,365 slots of the
3-layer MLP), and one count launch and at most one scatter launch of the
select-compact kernel a group to encode every participant's upload
(``comm.wire.encode_round``).  Padded slots take no SGD step (their loss
is masked by validity), carry no DP noise, are zeroed with
``torch.where(valid, …)``, and are never encoded: only slots
``[:p_count]`` leave the engine.

The fused round loop (``fuse_rounds`` > 1) runs a chunk of S planned
rounds with the server sum on the device: ``prepare_fused_plan`` makes
every host→device copy of the chunk (its ``(S, B)`` rows, validity, lr
values, permutations, DP normals and sampled-quantile indices);
``fused_scbf_chunk`` runs each round — ``_slot_pass`` then
``fed.strategy.scbf_sum_step`` — as one replay of a CUDA graph captured
once a geometry (``fed.graphs``; the body itself, eagerly, on the CPU);
``emit_fused_payloads`` encodes the chunk's uploads after it.  The
round's slot count is run-constant (``fused_num_slots``), so a run
captures one graph a geometry.

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
the batched engine one ``(P, *leaf)`` tensor a leaf a round
(``draw_noise``, which the fused loop calls a round at a time before
the chunk).

Both engines are pure round executors: ``core.scbf.run_federated`` owns
the random draws — each participant's epoch permutations arrive in
``perms`` — so the trajectory does not depend on how the engine runs.
"""
from __future__ import annotations

from dataclasses import dataclass
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
from repro_torch.fed import graphs
from repro_torch.fed.cohort import (PaddedCohort, bucket_size,
                                    horizon_slot_plan, pad_clients)
from repro_torch.fed.strategy import fedavg_step, scbf_sum_step


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


def _slot_pass(params, cohort: PaddedCohort, rows: torch.Tensor,
               valid: torch.Tensor, lr, perms: torch.Tensor,
               cfg: ScbfConfig, *, batch_size: int, epochs: int,
               nmasks=None, noise=None, sample_idx=None,
               generator: Optional[torch.Generator] = None):
    """Train → delta → select → (DP) → validity zeroing for the B slots of
    one round: the body shared by the per-round pass and the fused round,
    which keeps the two bitwise equal.

    ``rows`` (B,) are the cohort rows the slots train on, ``valid`` (B,)
    the real slots, ``perms`` (B, epochs, n_max), ``noise`` the (B, *leaf)
    DP normals in ``wire.flat_keys`` order (zero on padded slots),
    ``sample_idx`` the sampled quantile path's indices (one list a slot;
    else drawn on ``generator``).  Returns (masked, masks, edge operands),
    slot-stacked; a padded slot's masked delta and masks are zero.
    """
    start, new_p = _train_slots(params, cohort, rows, valid, lr, perms,
                                batch_size=batch_size, epochs=epochs,
                                nmasks=nmasks)
    g = client_delta(start, new_p)
    masked, masks, _, ops = sel.select_gradients(
        g, cfg.upload_rate, cfg.selection, score_norm=cfg.score_norm,
        sample_idx=sample_idx, generator=generator, neuron_masks=nmasks)
    if cfg.dp_noise_multiplier > 0.0:
        masked = privacy.gaussian_mechanism(
            tuple(masked), noise, cfg.dp_noise_multiplier, cfg.dp_clip_norm,
            masks=_reveal_masks(masked, masks), slots=True)
        ops = _noised_operands(ops, masked)
    masked = tuple({k: _zero_invalid(t, valid) for k, t in layer.items()}
                   for layer in masked)
    masks = tuple(
        {k: (None if m is None else torch.logical_and(
            m, valid.reshape((-1,) + (1,) * (m.ndim - 1))))
         for k, m in layer.items()} for layer in masks)
    return masked, masks, ops


def _train_slots(params, cohort: PaddedCohort, rows: torch.Tensor,
                 valid: torch.Tensor, lr, perms: torch.Tensor, *,
                 batch_size: int, epochs: int, nmasks=None):
    """(the B slots' starting params — ``params`` broadcast — and their
    trained params): slot s trains on cohort row ``rows[s]``, the masked
    loss on a ragged cohort."""
    b = valid.shape[0]
    start = tuple({k: v.unsqueeze(0).expand(b, *v.shape)
                   for k, v in layer.items()} for layer in params)
    return start, local_train_slots(
        start, cohort.x, cohort.y, lr, perms,
        w=None if cohort.uniform else cohort.w, valid=valid,
        batch_size=batch_size, epochs=epochs, neuron_masks=nmasks,
        clients=rows)


def _zero_invalid(t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``t`` (slot-stacked) with every padded slot's entries zero; a real
    slot's are ``t``'s bitwise."""
    return torch.where(valid.reshape((-1,) + (1,) * (t.ndim - 1)), t,
                       torch.zeros_like(t))


@dataclass
class FusedPlan:
    """Device-resident plan of one fused chunk of rounds, built by
    ``BatchedEngine.prepare_fused_plan`` — where every host→device copy of
    the chunk happens, so the chunk itself copies nothing from the host."""

    rounds: int                       # real rounds in the chunk (<= S)
    num_slots: int                    # B, constant across the run
    participants: List[np.ndarray]    # per real round (host ids)
    part_idx: torch.Tensor            # (S, B) int64 cohort rows
    valid: torch.Tensor               # (S, B) bool slot validity
    lrs: torch.Tensor                 # (S,) fp32 lr table slice
    perms: torch.Tensor               # (S, B, epochs, n_max) int64
    weights: Optional[torch.Tensor] = None   # (S, B) fp32 — fedavg only
    noise: Optional[List[torch.Tensor]] = None   # (S, B, *leaf) DP normals
    sample_idx: Optional[List[torch.Tensor]] = None  # (S, B, n) a layer


@dataclass
class FusedOutputs:
    """A fused SCBF chunk's stacked per-round results, on the device, for
    the emission after the chunk: every leaf ``(S, B, …)``."""

    masked: Tuple[dict, ...]
    masks: Tuple[dict, ...]
    ops: List[EdgeOperands]           # a shared (M,) row stays (M,)


def _stack_perms(blocks: Sequence[np.ndarray], num_slots: int,
                 horizon: int, epochs: int, n: int) -> np.ndarray:
    """(horizon, num_slots, epochs, n) int64 from per-round (P_r, epochs,
    n) permutation blocks.  Padded slots and missing rounds get the
    identity permutation: they take no step and their outputs are
    zeroed, and no padded slot shares a participant's draw."""
    out = np.broadcast_to(np.arange(n, dtype=np.int64),
                          (horizon, num_slots, epochs, n)).copy()
    for r, block in enumerate(blocks):
        out[r, :block.shape[0]] = block
    return out


class BatchedEngine:
    """Slot-stacked bucketed-cohort execution: one pass a round (see the
    module docstring), or a fused chunk of rounds a captured round at a
    time.  ``bucket`` picks the participant padding
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
        self._programs = {}           # program key -> RoundProgram

    @property
    def num_clients(self) -> int:
        return self.cohort.num_clients

    def perm_length(self, k: int) -> int:
        """The length of every epoch permutation: the padded shard,
        n_max, which the masked loss batches (the reference permutes
        ``x.shape[0]`` of the padded shard)."""
        return self.cohort.n_max

    def round_slots(self, p_count: int) -> int:
        """B of a per-round pass of ``p_count`` participants."""
        return bucket_size(p_count, self.num_clients, self.bucket)

    def _slot_inputs(self, participants, perms, b: int):
        """(rows (B,), valid (B,), perms (B, epochs, n_max)) on the device,
        padded slots training on slot 0's row with the identity
        permutation; one host→device copy each."""
        p_count = len(participants)
        rows = np.full(b, int(participants[0]), np.int64)
        rows[:p_count] = np.asarray(participants, np.int64)
        pm = _stack_perms([_perm_block(perms)], b, 1, self.epochs,
                          self.cohort.n_max)[0]
        return (torch.from_numpy(rows).to(self.device),
                torch.arange(b, device=self.device) < p_count,
                torch.from_numpy(pm).to(self.device))

    def draw_noise(self, params, p_count: int, noise=None,
                   generator: Optional[torch.Generator] = None
                   ) -> List[torch.Tensor]:
        """One (P, *leaf) normal tensor a leaf, in ``wire.flat_keys``
        order, on the device: the participants' injected normals
        (``noise[i]``, one array a leaf), or one ``torch.randn`` a leaf on
        ``generator``."""
        if noise is None:
            real = tuple({k: v.unsqueeze(0).expand(p_count, *v.shape)
                          for k, v in layer.items()} for layer in params)
            return privacy.draw_normals(real, generator)
        return [torch.from_numpy(np.stack([np.asarray(noise[i][j],
                                                      np.float32)
                                           for i in range(p_count)]))
                .to(self.device) for j in range(len(noise[0]))]

    def _pass(self, params, participants, lr, perms, cfg, nmasks=None,
              noise=None, generator=None, sample_idx=None):
        b = self.round_slots(len(participants))
        rows, valid, pm = self._slot_inputs(participants, perms, b)
        if noise is not None:
            noise = [torch.cat([z, z.new_zeros((b - z.shape[0],
                                                *z.shape[1:]))])
                     for z in noise]
        if sample_idx is not None:
            idx = torch.from_numpy(sample_idx).to(self.device)
            sample_idx = [list(slot) for slot in idx]
        return _slot_pass(params, self.cohort, rows, valid, lr, pm, cfg,
                          batch_size=self.batch_size, epochs=self.epochs,
                          nmasks=nmasks, noise=noise, sample_idx=sample_idx,
                          generator=generator)

    def scbf_round(self, params, participants, lr: float,
                   perms: Sequence[Sequence], cfg: ScbfConfig,
                   generator: Optional[torch.Generator] = None,
                   nmasks=None, keep=None, noise=None,
                   dp_generator: Optional[torch.Generator] = None,
                   sample_idx: Optional[np.ndarray] = None
                   ) -> Tuple[List[wire.Payload], List[sel.UploadStats]]:
        """Masked sparse uploads for every participant, one slot-stacked
        pass: train → delta → select → DP → validity zeroing → (keep
        compaction) → one round encode.  ``sample_idx`` (B, layers, n)
        int64: the sampled quantile path's indices of the round's slots
        (else drawn on ``generator``).  An empty round returns
        ``([], [])`` without launching anything."""
        p_count = len(participants)
        if not p_count:
            return [], []
        z = self.draw_noise(params, p_count, noise, dp_generator) \
            if cfg.dp_noise_multiplier > 0.0 else None
        masked, masks, ops = self._pass(params, participants, lr, perms, cfg,
                                        nmasks, z, generator, sample_idx)
        return self._emit(masked, masks, ops, p_count, keep)

    def _emit(self, masked, masks, ops, num: int, keep=None):
        """Encode slots [:num] (after keep compaction): (payloads, stats)."""
        if keep is not None:
            keep_t = index_tensors(keep, self.device)
            masked = _compact_layers(masked, keep_t)
            masks = _compact_layers(masks, keep_t)
            ops = _compact_operands(ops, keep_t)
        return (wire.encode_round(masked, ops, num),
                sel.UploadStats.from_slot_masks(masks, num))

    def fedavg_round(self, params, participants, lr: float,
                     perms: Sequence[Sequence]):
        """Full-weight training, slot-stacked; returns (per-client params
        — views into the stacked output's real slots — and counts)."""
        p_count = len(participants)
        if not p_count:
            return [], self.counts[:0]
        b = self.round_slots(p_count)
        rows, valid, pm = self._slot_inputs(participants, perms, b)
        _, new_p = _train_slots(params, self.cohort, rows, valid, lr, pm,
                                batch_size=self.batch_size,
                                epochs=self.epochs)
        real = tuple({k: v[:p_count] for k, v in layer.items()}
                     for layer in new_p)
        res = [tuple({k: v[i] for k, v in layer.items()} for layer in real)
               for i in range(p_count)]
        return res, self.counts[np.asarray(participants)]

    # ------------------------------------------------------------------
    # the fused round loop: S rounds a chunk, a captured round each
    # ------------------------------------------------------------------

    def fused_num_slots(self, max_participants: int) -> int:
        """The run-constant slot count B of fused rounds, sized to the
        scheduler's largest cohort: every round of the run replays one
        captured graph."""
        return bucket_size(max_participants, self.num_clients, self.bucket)

    def prepare_fused_plan(self, participants: Sequence[np.ndarray],
                           lrs: Sequence[float], perms: Sequence,
                           horizon: int, num_slots: int, weights=None,
                           noise=None, sample_idx=None) -> FusedPlan:
        """Assemble one chunk's static (S, B) plan on the device — every
        host→device copy of the chunk happens here, one a tensor.

        ``perms[r][i]``: round r's participant i's per-epoch permutations;
        ``weights[r]`` (P_r,) fedavg example weights; ``noise[r]``: round
        r's DP normals, one (P_r, *leaf) tensor a leaf (``draw_noise``;
        P_r = 0 for an empty round); ``sample_idx[r]`` (k_r, layers, n)
        int64: the sampled quantile path's indices of the k_r slots the
        per-round pass draws for (``core.channels.sample_channels``).
        Padded slots repeat slot 0's row, get the identity permutation
        and zero noise; rounds past the real ones are all-invalid.
        """
        parts = [np.asarray(p) for p in participants]
        part_idx, valid = horizon_slot_plan(parts, num_slots, horizon)
        dev = self.device
        pm = _stack_perms([_perm_block(perms[r]) if parts[r].size else
                           np.zeros((0, self.epochs, self.cohort.n_max),
                                    np.int64)
                           for r in range(len(parts))], num_slots, horizon,
                          self.epochs, self.cohort.n_max)
        lr_arr = np.zeros(horizon, np.float32)
        lr_arr[:len(lrs)] = np.asarray(lrs, np.float32)
        plan = FusedPlan(
            rounds=len(parts), num_slots=num_slots, participants=parts,
            part_idx=torch.from_numpy(part_idx.astype(np.int64)).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            lrs=torch.from_numpy(lr_arr).to(dev),
            perms=torch.from_numpy(pm).to(dev))
        if weights is not None:
            wts = np.zeros((horizon, num_slots), np.float32)
            for r, w in enumerate(weights):
                w = np.asarray(w, np.float32)
                wts[r, :w.shape[0]] = w
            plan.weights = torch.from_numpy(wts).to(dev)
        if noise is not None:
            plan.noise = [torch.zeros((horizon, num_slots, *z.shape[1:]),
                                      dtype=torch.float32, device=dev)
                          for z in noise[0]]
            for r, zs in enumerate(noise):
                for buf, z in zip(plan.noise, zs):
                    buf[r, :z.shape[0]].copy_(z)
        if sample_idx is not None:
            idx = np.zeros((horizon, num_slots) + sample_idx[0].shape[1:],
                           np.int64)
            for r, rnd in enumerate(sample_idx):
                idx[r, :rnd.shape[0]] = rnd
            plan.sample_idx = [torch.from_numpy(
                np.ascontiguousarray(idx[:, :, l])).to(dev)
                for l in range(idx.shape[2])]
        return plan

    def _program(self, key, fn, example: tuple) -> graphs.RoundProgram:
        """The captured round program of ``key`` (CUDA), captured at first
        use from the ``example`` inputs."""
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = graphs.RoundProgram(fn, *example)
        return prog

    def fused_scbf_chunk(self, params, plan: FusedPlan, cfg: ScbfConfig,
                         nmasks=None) -> Tuple[Tuple[dict, ...],
                                               FusedOutputs]:
        """Run one fused SCBF chunk: for each round of the plan, the round
        body — slot pass, validity zeroing and ``scbf_sum_step`` — as one
        replay of a captured graph (an eager call on the CPU), with the
        round's rows of the plan copied into its inputs on the device.
        No host sync.  Returns (new params, the chunk's stacked masked
        deltas, masks and edge operands for ``emit_fused_payloads``).
        ``nmasks`` (mask-mode SCBFwP): the chunk's keep-masks, an input."""
        def body(p, rows, valid, lr, perms, noise, sample, nm):
            sample = None if sample is None else \
                [[s[k] for s in sample] for k in range(rows.shape[0])]
            masked, masks, ops = _slot_pass(
                p, self.cohort, rows, valid, lr, perms, cfg,
                batch_size=self.batch_size, epochs=self.epochs, nmasks=nm,
                noise=noise, sample_idx=sample)
            return scbf_sum_step(p, masked, neuron_masks=nm), masked, \
                masks, ops

        p = tuple(params)
        nm = None if nmasks is None else tuple(nmasks)
        out = None
        for r in range(plan.part_idx.shape[0]):
            rows, valid, lr, perms = (plan.part_idx[r], plan.valid[r],
                                      plan.lrs[r], plan.perms[r])
            noise = None if plan.noise is None else \
                [z[r] for z in plan.noise]
            sample = None if plan.sample_idx is None else \
                [s[r] for s in plan.sample_idx]
            prog = body if self.device.type != "cuda" else self._program(
                graphs.program_key("scbf", cfg, p, rows, perms, noise,
                                   sample, nm),
                body, (p, rows, valid, lr, perms, noise, sample, nm))
            p, masked, masks, ops = prog(p, rows, valid, lr, perms, noise,
                                         sample, nm)
            if out is None:
                out = _stacked_like(plan.part_idx.shape[0], masked, masks,
                                    ops)
            _store_round(out, r, masked, masks, ops)
        return tuple({k: v.clone() for k, v in layer.items()}
                     for layer in p), out

    def fused_fedavg_chunk(self, params, plan: FusedPlan
                           ) -> Tuple[dict, ...]:
        """Run one fused FedAvg chunk (a captured round each: slot-stacked
        training, then ``fedavg_step`` with the plan's weights); returns
        the final params."""
        if plan.weights is None:
            raise ValueError("fused fedavg needs the plan built with "
                             "per-slot example weights")

        def body(p, rows, valid, lr, perms, wts):
            _, trained = _train_slots(p, self.cohort, rows, valid, lr,
                                      perms, batch_size=self.batch_size,
                                      epochs=self.epochs)
            # a padded slot (weight 0) adds exact zeros
            return fedavg_step(p, tuple(
                {k: _zero_invalid(t, valid) for k, t in layer.items()}
                for layer in trained), wts)

        p = tuple(params)
        for r in range(plan.part_idx.shape[0]):
            rows, valid, lr, perms, wts = (
                plan.part_idx[r], plan.valid[r], plan.lrs[r], plan.perms[r],
                plan.weights[r])
            prog = body if self.device.type != "cuda" else self._program(
                graphs.program_key("fedavg", p, rows, perms),
                body, (p, rows, valid, lr, perms, wts))
            p = prog(p, rows, valid, lr, perms, wts)
        return tuple({k: v.clone() for k, v in layer.items()}
                     for layer in p)

    def run_fused_chunk(self, method: str, params, plan: FusedPlan,
                        cfg: ScbfConfig, nmasks=None, keep=None):
        """One fused chunk of ``method`` and its uploads: (new params,
        ``[(payloads, stats), …]`` a real round — empty for FedAvg, which
        ships dense weights)."""
        if method == "fedavg":
            return self.fused_fedavg_chunk(params, plan), \
                [([], []) for _ in range(plan.rounds)]
        new_params, out = self.fused_scbf_chunk(params, plan, cfg,
                                                nmasks=nmasks)
        return new_params, self.emit_fused_payloads(out, plan, keep=keep)

    def emit_fused_payloads(self, out: FusedOutputs, plan: FusedPlan,
                            keep=None
                            ) -> List[Tuple[List[wire.Payload],
                                            List[sel.UploadStats]]]:
        """The chunk's uploads, encoded after it: the real slots of every
        real round, in round order, gathered into one slot-stacked table
        and encoded as one round (``wire.encode_round``: one K3 count
        launch and at most one K3 scatter a group of ``MAX_SLOTS``
        (leaf, slot) pairs) with ``UploadStats`` from one host copy.
        ``keep`` (mask-mode SCBFwP) compacts every slot to the effective
        geometry first.  Returns ``[(payloads, stats), …]`` a real round;
        padded slots and rounds ship nothing."""
        sizes = [int(p.size) for p in plan.participants]
        s_count, b = plan.part_idx.shape
        flat = [r * b + i for r, n in enumerate(sizes) for i in range(n)]
        if not flat:
            return [([], []) for _ in sizes]
        pick = None if len(flat) == s_count * b else \
            torch.tensor(flat, dtype=torch.int64, device=self.device)

        def take(t):
            t = t.reshape(s_count * b, *t.shape[2:])
            return t if pick is None else t.index_select(0, pick)

        masked = tuple({k: take(v) for k, v in layer.items()}
                       for layer in out.masked)
        masks = tuple({k: None if v is None else take(v)
                       for k, v in layer.items()} for layer in out.masks)
        ops = [op._replace(g=masked[l]["w"], col=take(op.col),
                           thr=take(op.thr), rest=take(op.rest),
                           row=take(op.row) if op.row.ndim == 3 else op.row)
               for l, op in enumerate(out.ops)]
        payloads, stats = self._emit(masked, masks, ops, len(flat), keep)
        res, at = [], 0
        for n in sizes:
            res.append((payloads[at:at + n], stats[at:at + n]))
            at += n
        return res


def _perm_block(perms) -> np.ndarray:
    """(P, epochs, n) int64 from per-participant lists of per-epoch
    permutations (numpy arrays or tensors)."""
    return np.stack([np.stack([p.numpy() if isinstance(p, torch.Tensor)
                               else np.asarray(p) for p in row])
                     for row in perms]).astype(np.int64)


def _stacked_like(s_count: int, masked, masks, ops) -> FusedOutputs:
    """Empty (S, …) stacks shaped like one round's outputs (EdgeOperands
    keep only row, col, thr and rest: the emission compacts the masked
    weights, which under the same rule hold the same kept entries)."""
    def stack(t):
        return None if t is None else t.new_empty((s_count, *t.shape))
    return FusedOutputs(
        masked=tuple({k: stack(v) for k, v in layer.items()}
                     for layer in masked),
        masks=tuple({k: stack(v) for k, v in layer.items()}
                    for layer in masks),
        ops=[op._replace(g=None, col=stack(op.col), thr=stack(op.thr),
                         rest=stack(op.rest),
                         row=stack(op.row) if op.row.ndim == 2
                         else op.row.clone()) for op in ops])


def _store_round(out: FusedOutputs, r: int, masked, masks, ops) -> None:
    """Copy round r's outputs into the chunk's stacks (on the device)."""
    for dst, src in ((out.masked, masked), (out.masks, masks)):
        for d, s in zip(dst, src):
            for k, v in s.items():
                if v is not None:
                    d[k][r].copy_(v)
    for d, s in zip(out.ops, ops):
        for name in ("col", "thr", "rest"):
            getattr(d, name)[r].copy_(getattr(s, name))
        if s.row.ndim == 2:
            d.row[r].copy_(s.row)


ENGINES = {"batched": BatchedEngine, "sequential": SequentialEngine}


def make_engine(kind: str, clients, batch_size: int, epochs: int, device,
                bucket: str = "pow2", pods: int = 1):
    if kind not in ENGINES:
        raise ValueError(f"unknown engine {kind!r}; one of {sorted(ENGINES)}")
    return ENGINES[kind](clients, batch_size, epochs, device, bucket=bucket,
                         pods=pods)
