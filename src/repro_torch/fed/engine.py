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
``BatchedEngine._replay_rounds`` runs each round — a method's train
half, the pods' gather, its server half (``_fused_round``, the
reference's ``round_body``) — as one replay of a CUDA graph captured
once a geometry (``fed.graphs``; eagerly on the CPU), and a captured
round holds its inputs and the data of ``RoundData``, never the engine;
``emit_fused_payloads`` encodes the chunk's uploads after it.  The
round's slot count is run-constant (``fused_num_slots``).  The server
sum folds in only the slots of the plan's ``(S, B)`` admit mask
(``torch.where(admit, Δ, 0)``: a rejected slot adds exact zeros); a
fault-free plan admits the valid slots, which changes no bit.

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

Stale starting points (FedBuff, and spilled arrivals of the simulated
clock): ``scbf_round`` takes a list of per-participant params instead of
one shared model; the batched engine stacks them (a padded slot repeats
slot 0's) and the slot pass trains, differences and selects every slot
from its own start, still one launch of each kernel a round.

Device telemetry (``collect=True``, ``repro_torch.obs``): the trainers
return each slot's loss with the parameters (``with_loss``), and the
batched engine's round returns its ``MetricsCarry`` (loss, selected
channels, bytes by codec, priced on the masked deltas the round
uploads), offloaded in one copy a round — or, fused, stored into an
``(S,)`` stack inside each captured round and offloaded once a chunk
after the emission.  The sequential engine reads the same numbers from
its encoded payloads (``_host_round_metrics``).  Collection changes no
parameter bit.

Both engines are pure round executors: ``core.scbf.run_federated`` owns
the random draws — each participant's epoch permutations arrive in
``perms`` — so the trajectory does not depend on how the engine runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

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
from repro_torch.comm import collectives
from repro_torch.sharding import mesh as meshes
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obstrace
from repro_torch.params import tree_map
from repro_torch.sharding import rules as shard_rules
from repro_torch.slots import SLOT_CHUNK


def stack_pytrees(trees: Sequence):
    """Stack a list of identically-shaped trees along a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


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


def _host_round_metrics(payloads, stats, losses):
    """The sequential engine's round telemetry, ``obsm.offload``'s dict:
    the bytes from the encoded payloads (the wire is the byte source of
    truth), the mean of the clients' losses."""
    return {
        "participants": len(payloads),
        "train_loss": (sum(losses) / len(losses)) if losses else 0.0,
        "sparse_bytes": int(sum(p.nbytes for p in payloads)),
        "codec_bytes": wire.codec_breakdown(payloads),
    }


def _host_fedavg_metrics(losses, num: int):
    """The sequential engine's FedAvg round telemetry: the cohort's mean
    loss only — a declared aggregation point of the privacy lint, so no
    per-client value joins the dict."""
    return {
        "participants": num,
        "train_loss": (sum(losses) / len(losses)) if losses else 0.0,
    }


def _host_losses(losses: Sequence[torch.Tensor]) -> List[float]:
    """The clients' 0-d loss tensors as floats, in one host copy."""
    return torch.stack(list(losses)).cpu().tolist() if losses else []


class SequentialEngine:
    """The per-client Python loop."""

    name = "sequential"

    def __init__(self, clients: Sequence[Tuple[np.ndarray, np.ndarray]],
                 batch_size: int, epochs: int, device, bucket: str = "pow2",
                 pods: int = 1, mesh=None):
        if pods > 1 or mesh is not None:
            raise ValueError("the sequential engine is single-device; "
                             "pod sharding needs engine='batched'")
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

    def _train(self, params, k: int, lr: float, perms, nmasks=None,
               with_loss: bool = False):
        xc, yc = self.clients[int(k)]
        return local_train_impl(tuple(params), xc, yc, lr, perms=perms,
                                batch_size=self.batch_size,
                                epochs=self.epochs, neuron_masks=nmasks,
                                with_loss=with_loss)

    def scbf_round(self, params, participants, lr: float,
                   perms: Sequence[Sequence], cfg: ScbfConfig,
                   generator: Optional[torch.Generator] = None,
                   nmasks=None, keep=None, noise=None,
                   dp_generator: Optional[torch.Generator] = None,
                   collect: bool = False):
        """Train, select, (noise) and encode every participant; ``perms[i]``
        holds participant i's per-epoch permutations, ``noise[i]`` its DP
        normals.  ``params``: one model, or a list of one a participant
        (stale starts).  ``nmasks``/``keep``: mask-mode SCBFwP (see the
        module docstring).  Returns (payloads, stats), and with
        ``collect`` the round's telemetry dict (``_host_round_metrics``)."""
        keep_t = index_tensors(keep, self.device) if keep is not None \
            else None
        stacked = isinstance(params, list)
        payloads, stats, losses = [], [], []
        for i, k in enumerate(participants):
            p0 = tuple(params[i]) if stacked else tuple(params)
            new_p = self._train(p0, k, lr, perms[i], nmasks, collect)
            if collect:
                new_p, loss = new_p
                losses.append(loss)        # on the device; read once below
            g = client_delta(p0, new_p)
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
        if collect:
            return payloads, stats, _host_round_metrics(
                payloads, stats, _host_losses(losses))
        return payloads, stats

    def fedavg_round(self, params, participants, lr: float,
                     perms: Sequence[Sequence], collect: bool = False):
        """Every participant's trained params and example counts (and with
        ``collect`` the round's telemetry dict)."""
        outs = [self._train(params, k, lr, perms[i], with_loss=collect)
                for i, k in enumerate(participants)]
        counts = self.counts[np.asarray(participants)]
        if collect:
            return [o for o, _ in outs], counts, _host_fedavg_metrics(
                _host_losses([l for _, l in outs]), len(outs))
        return outs, counts


def _slot_pass(params, cohort: PaddedCohort, rows: torch.Tensor,
               valid: torch.Tensor, lr, perms: torch.Tensor,
               cfg: ScbfConfig, *, batch_size: int, epochs: int,
               nmasks=None, noise=None, sample_idx=None,
               generator: Optional[torch.Generator] = None,
               collect: bool = False, eff_sizes=None):
    """Train → delta → select → (DP) → validity zeroing for the B slots of
    one round: the body shared by the per-round pass and the fused round,
    which keeps the two bitwise equal.

    ``rows`` (B,) are the cohort rows the slots train on, ``valid`` (B,)
    the real slots, ``perms`` (B, epochs, n_max), ``noise`` the (B, *leaf)
    DP normals in ``wire.flat_keys`` order (zero on padded slots),
    ``sample_idx`` the sampled quantile path's indices (one list a slot;
    else drawn on ``generator``).  ``params``: one model shared by every
    slot, or a slot-stacked ``(B, …)`` one, each slot's own start (stale
    versions; ``_train_slots``).  Returns (masked, masks), slot-stacked;
    a padded slot's masked delta and masks are zero.  With
    ``collect``, also the slots' ``(B,)``-stacked ``MetricsCarry``
    (``obsm.slot_metrics``: the loss from training, the counts from the
    zeroed uploads, ``eff_sizes`` the mask-mode byte pricing, a device
    input); the parameter arithmetic is the same bitwise.
    """
    start, new_p = _train_slots(params, cohort, rows, valid, lr, perms,
                                batch_size=batch_size, epochs=epochs,
                                nmasks=nmasks, with_loss=collect)
    if collect:
        new_p, loss = new_p
    g = client_delta(start, new_p)
    masked, masks, _, _ = sel.select_gradients(
        g, cfg.upload_rate, cfg.selection, score_norm=cfg.score_norm,
        sample_idx=sample_idx, generator=generator, neuron_masks=nmasks)
    if cfg.dp_noise_multiplier > 0.0:
        masked = privacy.gaussian_mechanism(
            tuple(masked), noise, cfg.dp_noise_multiplier, cfg.dp_clip_norm,
            masks=_reveal_masks(masked, masks), slots=True)
    masked = tuple({k: _zero_invalid(t, valid) for k, t in layer.items()}
                   for layer in masked)
    masks = tuple(
        {k: (None if m is None else torch.logical_and(
            m, valid.reshape((-1,) + (1,) * (m.ndim - 1))))
         for k, m in layer.items()} for layer in masks)
    if collect:
        # a declared aggregation point: the slots' losses are gated by
        # validity and summed over the cohort on the device
        # (``obsm.reduce_slots``) before anything is offloaded
        # privlint: disable=PL006
        return masked, masks, obsm.slot_metrics(loss, masked, masks, valid,
                                                eff_sizes)
    return masked, masks


def _train_slots(params, cohort: PaddedCohort, rows: torch.Tensor,
                 valid: torch.Tensor, lr, perms: torch.Tensor, *,
                 batch_size: int, epochs: int, nmasks=None,
                 with_loss: bool = False):
    """(the B slots' starting params and their trained params): slot s
    trains on cohort row ``rows[s]``, the masked loss on a ragged cohort.
    ``params`` is one model, broadcast to the B slots, or already slot-
    stacked (its weights one dimension up).  ``with_loss``: the trained
    params are ``(params, (B,) losses)``.  The slots train padded to a
    multiple of ``SLOT_CHUNK`` — padded slots invalid, on slot 0's row,
    start and permutations, cut off after — so every product runs in
    whole chunks (``repro_torch.slots``), padded once and not a product
    at a time."""
    b = valid.shape[0]
    pad = -b % SLOT_CHUNK

    def grow(t):
        return torch.cat([t, t[:1].expand(pad, *t.shape[1:])]) if pad \
            else t

    if params[0]["w"].ndim == 3:
        start = params
        train = tree_map(grow, params)
    else:
        train = tuple({k: v.unsqueeze(0).expand(b + pad, *v.shape)
                       for k, v in layer.items()} for layer in params)
        start = tree_map(lambda t: t[:b], train)
    out = local_train_slots(
        train, cohort.x, cohort.y, lr, grow(perms),
        w=None if cohort.uniform else cohort.w,
        valid=torch.cat([valid, valid.new_zeros(pad)]) if pad else valid,
        batch_size=batch_size, epochs=epochs, neuron_masks=nmasks,
        clients=grow(rows), with_loss=with_loss)
    new_p, loss = out if with_loss else (out, None)
    new_p = tree_map(lambda t: t[:b], new_p)
    return start, (new_p, loss[:b]) if with_loss else new_p


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
    # (S, B) bool: the slots the server sum folds in (fed.faults' plan-
    # time verdicts); a fault-free plan admits the valid slots
    admit: torch.Tensor
    weights: Optional[torch.Tensor] = None   # (S, B) fp32 — fedavg only
    noise: Optional[List[torch.Tensor]] = None   # (S, B, *leaf) DP normals
    sample_idx: Optional[List[torch.Tensor]] = None  # (S, B, n) a layer
    # (n_leaves,) int32: the effective leaf sizes the telemetry prices
    # (mask-mode SCBFwP while not compacted)
    eff_sizes: Optional[torch.Tensor] = None


@dataclass
class FusedOutputs:
    """A fused SCBF chunk's stacked per-round results, on the device, for
    the emission after the chunk: every leaf ``(S, B, …)``."""

    masked: Tuple[dict, ...]
    masks: Tuple[dict, ...]
    metrics: Optional[obsm.MetricsCarry] = None   # (S,)-stacked, collect


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
    (``fed.cohort.bucket_size``).

    Pods (``pods`` > 1, or a ``mesh`` given): the round's slot axis splits
    over the 1-D ``("pod",)`` mesh of ``sharding.mesh`` (``make_pod_mesh``
    over the initialised group by default), one contiguous block of B/P
    slots a rank (``sharding.rules``); B is a multiple of P.  A rank
    trains, selects and noises its own slots — K1, K2 and K3's count
    once a round a rank — then the masked slot stacks, their masks and
    the telemetry carry are gathered in slot order (``collectives.gather_slots``),
    so the server sum, the encode and the carry's reduction see all B
    slots exactly as on one device: the uploads and the sum are bitwise
    one device's.  Only masked deltas (zero outside their channels),
    their masks and the carry cross.  Every rank holds the whole cohort
    on the device (replicated, as in the reference's fused path) and its
    slots index it.  Every rank draws a round's randomness for all its
    participants in the one-device order (``draw_slots``,
    ``draw_noise``) and takes its slots' rows.

    The encode (``_emit``) re-derives each upload from its masked values
    alone (``_passthrough_operands``): a masked delta is zero outside the
    edges its selection kept, so no channel score leaves the slot pass,
    on one device or across pods.
    """

    name = "batched"

    def __init__(self, clients: Sequence[Tuple[np.ndarray, np.ndarray]],
                 batch_size: int, epochs: int, device, bucket: str = "pow2",
                 pods: int = 1, mesh=None):
        bucket_size(1, 1, bucket)         # refuse an unknown policy now
        self.device = torch.device(device)
        self.pods = max(1, int(pods))
        if mesh is None and self.pods > 1:
            mesh = meshes.make_pod_mesh(self.pods, device=self.device)
        if mesh is not None:
            if self.pods not in (1, mesh.size()):
                raise ValueError(f"a pod mesh of {mesh.size()} ranks for "
                                 f"pods={self.pods}")
            self.pods = mesh.size()
        self.mesh = mesh
        self.cohort: PaddedCohort = pad_clients(clients, self.device)
        self.counts = self.cohort.counts
        self.batch_size = batch_size
        self.epochs = epochs
        self.bucket = bucket
        self._programs = {}           # program key -> RoundProgram
        self._round_data = {}         # (cfg, collect) -> RoundData

    @property
    def num_clients(self) -> int:
        return self.cohort.num_clients

    def perm_length(self, k: int) -> int:
        """The length of every epoch permutation: the padded shard,
        n_max, which the masked loss batches (the reference permutes
        ``x.shape[0]`` of the padded shard)."""
        return self.cohort.n_max

    def round_slots(self, p_count: int) -> int:
        """B of a per-round pass of ``p_count`` participants (a multiple
        of the pod count)."""
        return bucket_size(p_count, self.num_clients, self.bucket,
                           self.pods)

    def draw_slots(self, p_count: int) -> int:
        """The slots a round's per-slot draws cover: one device's bucket,
        whatever the pods, so every rank draws the one-device stream."""
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

    def _mine(self, b: int) -> slice:
        """This rank's slots of a round of ``b`` (all of them on one
        device): the contiguous range of ``sharding.rules.slot_range``."""
        if self.mesh is None:
            return slice(0, b)
        return slice(*shard_rules.slot_range(b, self.mesh))

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
              noise=None, generator=None, sample_idx=None,
              collect: bool = False, eff_sizes=None):
        """The round's slot pass: on pods this rank's slots (``_mine``),
        then the round's masked deltas, masks and carry gathered in slot
        order."""
        b = self.round_slots(len(participants))
        mine = self._mine(b)
        rows, valid, pm = (t[mine] for t in self._slot_inputs(
            participants, perms, b))
        if isinstance(params, list):
            params = tuple({k: v[mine] for k, v in layer.items()}
                           for layer in _stack_params(params, b))
        if noise is not None:
            noise = [_zero_fill_slots(z, b)[mine] for z in noise]
        if sample_idx is not None:
            idx = torch.from_numpy(sample_idx).to(self.device)
            sample_idx = [list(slot) for slot in
                          _zero_fill_slots(idx, b)[mine]]
        # on pods the sampled quantile's indices come drawn for the whole
        # round (``sample_idx``): a rank's own draws would shift the stream
        return _gather_slots(self.mesh, _slot_pass(
            params, self.cohort, rows, valid, lr, pm, cfg,
            batch_size=self.batch_size, epochs=self.epochs, nmasks=nmasks,
            noise=noise, sample_idx=sample_idx,
            generator=generator if self.mesh is None else None,
            collect=collect, eff_sizes=eff_sizes))

    def scbf_round(self, params, participants, lr: float,
                   perms: Sequence[Sequence], cfg: ScbfConfig,
                   generator: Optional[torch.Generator] = None,
                   nmasks=None, keep=None, noise=None,
                   dp_generator: Optional[torch.Generator] = None,
                   sample_idx: Optional[np.ndarray] = None,
                   collect: bool = False):
        """Masked sparse uploads for every participant, one slot-stacked
        pass: train → delta → select → DP → validity zeroing → (keep
        compaction) → one round encode.  ``sample_idx`` (B, layers, n)
        int64: the sampled quantile path's indices of the round's slots
        (else drawn on ``generator``).  ``params``: one model, or a list of
        one a participant (stale starts, stacked into one pass).  Returns
        (payloads, stats) and with ``collect`` the round's offloaded
        telemetry dict (``keep`` priced as the effective geometry).  An
        empty round returns ``([], [])`` (``([], [], None)``) without
        launching anything."""
        p_count = len(participants)
        if not p_count:
            return ([], [], None) if collect else ([], [])
        shapes = params[0] if isinstance(params, list) else params
        z = self.draw_noise(shapes, p_count, noise, dp_generator) \
            if cfg.dp_noise_multiplier > 0.0 else None
        eff = None
        if collect and keep is not None:
            eff = torch.from_numpy(obsm.effective_leaf_sizes(
                shapes, keep)).to(self.device)
        out = self._pass(params, participants, lr, perms, cfg, nmasks, z,
                         generator, sample_idx, collect, eff)
        with obstrace.span("encode", clients=p_count):
            payloads, stats = self._emit(*out[:2], p_count, keep)
        if collect:
            return payloads, stats, obsm.offload(obsm.reduce_slots(out[2]))
        return payloads, stats

    def _emit(self, masked, masks, num: int, keep=None):
        """Encode slots [:num] (after keep compaction) from their masked
        values (``_passthrough_operands``): (payloads, stats); its
        device→host copies are those of ``wire.encode_round``."""
        if keep is not None:
            keep_t = index_tensors(keep, self.device)
            masked = _compact_layers(masked, keep_t)
            masks = _compact_layers(masks, keep_t)
        return (wire.encode_round(masked, _passthrough_operands(masked), num),
                sel.UploadStats.from_slot_masks(masks, num))

    def fedavg_round(self, params, participants, lr: float,
                     perms: Sequence[Sequence], collect: bool = False):
        """Full-weight training, slot-stacked; returns (per-client params
        — views into the stacked output's real slots — and counts), and
        with ``collect`` the round's offloaded loss dict (padded slots
        excluded by validity).  On pods every rank trains its slots, and
        the trained weights (what FedAvg ships) and losses are gathered
        in slot order."""
        p_count = len(participants)
        if not p_count:
            return ([], self.counts[:0], None) if collect \
                else ([], self.counts[:0])
        b = self.round_slots(p_count)
        mine = self._mine(b)
        rows, valid, pm = (t[mine] for t in self._slot_inputs(
            participants, perms, b))
        _, new_p = _train_slots(params, self.cohort, rows, valid, lr, pm,
                                batch_size=self.batch_size,
                                epochs=self.epochs, with_loss=collect)
        if collect:
            new_p, losses = new_p
        if self.mesh is not None:
            new_p, losses = _gather_slots(
                self.mesh, (new_p, losses if collect else None))
            valid = torch.arange(b, device=self.device) < p_count
        real = tuple({k: v[:p_count] for k, v in layer.items()}
                     for layer in new_p)
        res = [tuple({k: v[i] for k, v in layer.items()} for layer in real)
               for i in range(p_count)]
        counts = self.counts[np.asarray(participants)]
        if collect:
            return res, counts, obsm.offload(obsm.fedavg_metrics(losses,
                                                                 valid))
        return res, counts

    # ------------------------------------------------------------------
    # the fused round loop: S rounds a chunk, a captured round each
    # ------------------------------------------------------------------

    def fused_num_slots(self, max_participants: int) -> int:
        """The run-constant slot count B of fused rounds, sized to the
        scheduler's largest cohort (a multiple of the pod count): every
        round of the run replays one captured graph."""
        return bucket_size(max_participants, self.num_clients, self.bucket,
                           self.pods)

    def prepare_fused_plan(self, participants: Sequence[np.ndarray],
                           lrs: Sequence[float], perms: Sequence,
                           horizon: int, num_slots: int, weights=None,
                           noise=None, sample_idx=None,
                           admit=None, eff_sizes=None) -> FusedPlan:
        """Assemble one chunk's static (S, B) plan on the device — every
        host→device copy of the chunk happens here, one a tensor.

        ``perms[r][i]``: round r's participant i's per-epoch permutations;
        ``weights[r]`` (P_r,) fedavg example weights; ``noise[r]``: round
        r's DP normals, one (P_r, *leaf) tensor a leaf (``draw_noise``;
        P_r = 0 for an empty round); ``sample_idx[r]`` (k_r, layers, n)
        int64: the sampled quantile path's indices of the k_r slots the
        per-round pass draws for (``core.channels.sample_channels``).
        ``admit[r]`` (P_r,) bool: the slots round r's server sum folds in
        (None: every valid slot).  ``eff_sizes`` (n_leaves,) int32: the
        effective leaf sizes the chunk's telemetry prices (mask-mode
        SCBFwP; ``obsm.effective_leaf_sizes``), an input of each round.
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
        admit_arr = np.asarray(valid, dtype=bool)
        if admit is not None:
            admit_arr = np.zeros((horizon, num_slots), dtype=bool)
            for r, row in enumerate(admit):
                row = np.asarray(row, dtype=bool)
                admit_arr[r, :row.shape[0]] = row
        plan = FusedPlan(
            rounds=len(parts), num_slots=num_slots, participants=parts,
            part_idx=torch.from_numpy(part_idx.astype(np.int64)).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            lrs=torch.from_numpy(lr_arr).to(dev),
            perms=torch.from_numpy(pm).to(dev),
            admit=torch.from_numpy(admit_arr).to(dev))
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
        if eff_sizes is not None:
            plan.eff_sizes = torch.from_numpy(
                np.asarray(eff_sizes, np.int32)).to(dev)
        return plan

    def _program(self, key, fn, example: tuple) -> graphs.RoundProgram:
        """The captured round program of ``key`` (CUDA), captured at first
        use from the ``example`` inputs."""
        if key not in self._programs:
            self._programs[key] = graphs.RoundProgram(fn, *example)
        # looked up, not passed on: a caller names the body it replays
        # (``first = train if … else self._program(…)``) for the lints
        return self._programs[key]

    def round_form(self) -> str:
        """How a fused round runs: ``"one graph"`` (CUDA; on pods under
        NCCL the gather is captured inside it), ``"two graphs"`` (pods
        under gloo, which cannot be captured: the train and server halves,
        the gather between) or ``"eager"`` (the CPU)."""
        if self.device.type != "cuda":
            return "eager"
        if self.mesh is not None and torch.distributed.get_backend(
                self.mesh.get_group(meshes.POD)) != "nccl":
            return "two graphs"
        return "one graph"

    def _plan_view(self, plan: FusedPlan):
        """This rank's ``narrow`` of a fused plan's per-slot legs (the
        round-slot axis of ``fused_plan_shardings``), or the identity on
        one device."""
        if self.mesh is None:
            return lambda t: t
        shard, _ = shard_rules.fused_plan_shardings(self.mesh)
        a, e = shard_rules.slot_range(plan.num_slots, self.mesh)
        return lambda t: t.narrow(shard.dim, a, e - a)

    def _slot_rows(self, plan: FusedPlan):
        """This rank's (rows, valid, lrs, perms) of the plan, S views each."""
        view = self._plan_view(plan)
        return (view(plan.part_idx).unbind(0), view(plan.valid).unbind(0),
                plan.lrs.unbind(0), view(plan.perms).unbind(0))

    def _data(self, cfg: Optional[ScbfConfig], collect: bool) -> "RoundData":
        """The round halves' fixed arguments, one object a (cfg, collect)."""
        key = (cfg, bool(collect))
        return self._round_data.setdefault(key, RoundData(
            self.cohort, self.batch_size, self.epochs, self.mesh, *key))

    def _replay_rounds(self, train, server, data: "RoundData", params,
                       inputs, live: torch.Tensor, weights=None):
        """Run a fused chunk's rounds, either method's: round r trains this
        rank's slots (``train(data, p, tin)``, ``tin, extra = inputs(r)``),
        gathers, and steps (``server(data, p, outputs, live[r], extra)``).
        Form and program key are taken once a chunk.  Yields (params,
        outputs, carry) a round, valid until the next round."""
        form = self.round_form()
        # the validity the server takes: ``live``'s row (SCBF's admit row,
        # FedAvg's valid row) — except after a gather captured inside one
        # graph, where FedAvg's server takes the slots of positive weight
        # (a quorum-missed round weighs every slot 0)
        if weights is not None and form == "one graph" and \
                self.mesh is not None:
            live = weights > 0.0
        live = live.unbind(0)
        p = tuple(params)
        tin, ex = inputs(0)
        key = graphs.program_key(train, data, p, tin, live[0], ex)
        whole = _fused_round if form != "one graph" else self._program(
            key, _fused_round, (train, server, data, p, tin, live[0], ex))
        for r, lv in enumerate(live):
            tin, ex = inputs(r)
            if self.mesh is not None and form != "one graph":
                # the gather between the halves, outside any graph
                first = train if form == "eager" else self._program(
                    key + ("train",), train, (data, p, tin))
                out = _gather_slots(self.mesh, first(data, p, tin))
                second = server if form == "eager" else self._program(
                    key + ("server",), server, (data, p, out, lv, ex))
                p, met = second(data, p, out, lv, ex)
            else:
                p, out, met = whole(train, server, data, p, tin, lv, ex)
            yield p, out, met

    def fused_scbf_chunk(self, params, plan: FusedPlan, cfg: ScbfConfig,
                         nmasks=None, collect: bool = False
                         ) -> Tuple[Tuple[dict, ...], FusedOutputs]:
        """Run one fused SCBF chunk (``_replay_rounds``: slot pass, the
        gather on pods, ``scbf_sum_step`` on the admitted slots), no host
        sync.  Returns (new params, the chunk's stacked masked deltas and
        masks, every valid slot's, for ``emit_fused_payloads``).
        ``nmasks`` (mask-mode SCBFwP): the chunk's keep-masks.
        ``collect``: each round's ``MetricsCarry`` too (priced on
        ``plan.eff_sizes``), in the outputs' ``(S,)`` stack ``metrics``."""
        rows, valid, lrs, perms = self._slot_rows(plan)
        view, s = self._plan_view(plan), len(rows)
        # DP normals and sampled indices: a list of (S, B, …) legs each
        noise, sample = ([None] * s if legs is None else [
            list(r) for r in zip(*(view(t).unbind(0) for t in legs))]
            for legs in (plan.noise, plan.sample_idx))
        nm = None if nmasks is None else tuple(nmasks)
        es = plan.eff_sizes if collect else None

        def inputs(r):
            return (rows[r], valid[r], lrs[r], perms[r], noise[r], sample[r],
                    nm, es), nm

        p, out = tuple(params), None
        for r, (p, (masked, masks, _), met) in enumerate(self._replay_rounds(
                _fused_scbf_train, _fused_scbf_server,
                self._data(cfg, collect), p, inputs, plan.admit)):
            if out is None:
                out = _stacked_like(s, masked, masks, met)
            _store_round(out, r, masked, masks, met)
        return tuple({k: v.clone() for k, v in layer.items()}
                     for layer in p), out

    def fused_fedavg_chunk(self, params, plan: FusedPlan,
                           collect: bool = False):
        """Run one fused FedAvg chunk (``_replay_rounds``: slot-stacked
        training, the gather on pods, ``fedavg_step`` with the plan's
        weights); returns the final params, and with ``collect`` the
        chunk's ``(S,)``-stacked ``FedAvgMetrics`` on the device."""
        if plan.weights is None:
            raise ValueError("fused fedavg needs the plan built with "
                             "per-slot example weights")
        rows, valid, lrs, perms = self._slot_rows(plan)
        wts = plan.weights.unbind(0)

        def inputs(r):
            return (rows[r], valid[r], lrs[r], perms[r]), wts[r]

        p, stack = tuple(params), None
        for r, (p, _, met) in enumerate(self._replay_rounds(
                _fused_fedavg_train, _fused_fedavg_server,
                self._data(None, collect), p, inputs, plan.valid,
                weights=plan.weights)):
            if collect:
                if stack is None:
                    stack = _carry_stack(len(rows), met)
                _store_carry(stack, r, met)
        p = tuple({k: v.clone() for k, v in layer.items()} for layer in p)
        return (p, stack) if collect else p

    def run_fused_chunk(self, method: str, params, plan: FusedPlan,
                        cfg: ScbfConfig, nmasks=None, keep=None,
                        collect: bool = False):
        """One fused chunk of ``method``, its uploads and telemetry: (new
        params, ``[(payloads, stats), …]`` a real round — empty for
        FedAvg, which ships dense weights — and with ``collect`` the
        rounds' telemetry dicts, offloaded in one copy after the emission,
        else None).  The rounds' replays run in the ``replay`` span."""
        if method == "fedavg":
            with obstrace.span("replay"):
                out = self.fused_fedavg_chunk(params, plan, collect=collect)
            new_params, met = out if collect else (out, None)
            emitted = [([], []) for _ in range(plan.rounds)]
        else:
            with obstrace.span("replay"):
                new_params, res = self.fused_scbf_chunk(
                    params, plan, cfg, nmasks=nmasks, collect=collect)
            emitted = self.emit_fused_payloads(res, plan, keep=keep)
            met = res.metrics
        dms = obsm.offload(met, rounds=plan.rounds) if collect else None
        return new_params, emitted, dms

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
        with obstrace.span("encode", rounds=plan.rounds):
            return self._emit_chunk(out, plan, keep)

    def _emit_chunk(self, out: FusedOutputs, plan: FusedPlan, keep=None):
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
        payloads, stats = self._emit(masked, masks, len(flat), keep)
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


def _stack_params(params: Sequence, num_slots: int) -> Tuple[dict, ...]:
    """One ``(num_slots, …)`` model from a list of per-participant models,
    a padded slot repeating slot 0's (it takes no step and is zeroed)."""
    rows = list(params) + [params[0]] * (num_slots - len(params))
    return tuple({k: torch.stack([r[l][k] for r in rows])
                  for k in layer}
                 for l, layer in enumerate(params[0]))


def _zero_fill_slots(t: torch.Tensor, num_slots: int) -> torch.Tensor:
    """``t`` (P, …) with zero rows up to ``num_slots``."""
    return torch.cat([t, t.new_zeros((num_slots - t.shape[0],
                                      *t.shape[1:]))])


def _passthrough_operands(masked) -> List[EdgeOperands]:
    """Edge operands whose test every entry passes (``0 + 0 + 0 > -1``),
    on the masked weights of a slot-stacked round: the encoder then keeps
    exactly the masked values' nonzeros — what it keeps from the real
    operands, since a masked delta is zero outside its kept edges (and
    DP noises only revealed ones).  The batched engine's encode: no
    channel score leaves the slot pass, on one device or across pods."""
    out = []
    for layer in masked:
        w = layer["w"]
        zero = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
        out.append(EdgeOperands(
            w, torch.zeros(w.shape[-2], dtype=torch.float32, device=w.device),
            torch.zeros((w.shape[0], w.shape[-1]), dtype=torch.float32,
                        device=w.device), zero - 1.0, zero))
    return out


def _carry_stack(s_count: int, met):
    """An empty (S, …) stack of a round's telemetry carry."""
    return type(met)(*(t.new_empty((s_count, *t.shape)) for t in met))


def _store_carry(stack, r: int, met) -> None:
    """Copy round r's carry into the chunk's stack (on the device)."""
    for d, s in zip(stack, met):
        d[r].copy_(s)


def _stacked_like(s_count: int, masked, masks, met=None) -> FusedOutputs:
    """Empty (S, …) stacks shaped like one round's outputs."""
    def stack(t):
        return None if t is None else t.new_empty((s_count, *t.shape))
    return FusedOutputs(
        metrics=None if met is None else _carry_stack(s_count, met),
        masked=tuple({k: stack(v) for k, v in layer.items()}
                     for layer in masked),
        masks=tuple({k: stack(v) for k, v in layer.items()}
                    for layer in masks))


def _store_round(out: FusedOutputs, r: int, masked, masks,
                 met=None) -> None:
    """Copy round r's outputs into the chunk's stacks (on the device)."""
    if met is not None:
        _store_carry(out.metrics, r, met)
    for dst, src in ((out.masked, masked), (out.masks, masks)):
        for d, s in zip(dst, src):
            for k, v in s.items():
                if v is not None:
                    d[k][r].copy_(v)


@dataclass(frozen=True, eq=False)
class RoundData:
    """A fused round's fixed arguments: data only, so a captured round
    holds no engine; compared by identity (``BatchedEngine._data``)."""

    cohort: PaddedCohort
    batch_size: int
    epochs: int
    mesh: object                      # the pod mesh, or None
    cfg: Optional[ScbfConfig]         # None for FedAvg
    collect: bool


def _gather_slots(mesh, tree):
    """Every pod's slots of a round's slot-stacked outputs, in slot order;
    ``tree`` itself without a mesh."""
    if mesh is None:
        return tree
    return pytree.tree_map_only(
        torch.Tensor, lambda t: collectives.gather_slots(t, mesh), tree)


def _fused_round(train, server, data: RoundData, p, tin, live, extra):
    """One fused round (the reference's ``round_body``), one graph's body
    or an eager call: the train half on this rank's slots, the gather, the
    server half.  Returns (new params, the gathered outputs, the carry)."""
    out = _gather_slots(data.mesh, train(data, p, tin))
    new_p, met = server(data, p, out, live, extra)
    return new_p, out, met


def _fused_scbf_train(data: RoundData, p, tin):
    """SCBF's train half (``_fused_scbf_rounds``' slot pass): the slots'
    masked deltas, masks and carry (None unless collecting)."""
    rows, valid, lr, perms, noise, sample, nm, es = tin
    sample = None if sample is None else \
        [[s[k] for s in sample] for k in range(rows.shape[0])]
    res = _slot_pass(p, data.cohort, rows, valid, lr, perms, data.cfg,
                     batch_size=data.batch_size, epochs=data.epochs,
                     nmasks=nm, noise=noise, sample_idx=sample,
                     collect=data.collect, eff_sizes=es)
    return res[0], res[1], res[2] if data.collect else None


def _fused_scbf_server(data: RoundData, p, out, admit, nm):
    """SCBF's server half: the admitted slots' deltas summed into the model
    (a rejected slot adds exact zeros), the carry reduced."""
    masked, _, met = out
    admitted = tuple({k: _zero_invalid(t, admit) for k, t in layer.items()}
                     for layer in masked)
    return scbf_sum_step(p, admitted, neuron_masks=nm), \
        obsm.reduce_slots(met) if data.collect else None


def _fused_fedavg_train(data: RoundData, p, tin):
    """FedAvg's train half: the slots' trained weights and losses (None
    unless collecting)."""
    rows, valid, lr, perms = tin
    trained = _train_slots(p, data.cohort, rows, valid, lr, perms,
                           batch_size=data.batch_size, epochs=data.epochs,
                           with_loss=data.collect)[1]
    return trained if data.collect else (trained, None)


def _fused_fedavg_server(data: RoundData, p, out, live, wts):
    """FedAvg's server half: ``fedavg_step`` over the ``live`` slots (a
    padded slot adds exact zeros); a slot of positive weight counts."""
    trained, losses = out
    met = obsm.fedavg_metrics(losses, wts > 0.0) if data.collect else None
    return fedavg_step(p, tuple(
        {k: _zero_invalid(t, live) for k, t in layer.items()}
        for layer in trained), wts), met


ENGINES = {"batched": BatchedEngine, "sequential": SequentialEngine}


def scbf_compile_count() -> int:
    """The reference's jit-cache size of its batched SCBF pass.  The
    port runs the pass eagerly and compiles nothing per shape: 0."""
    return 0


def reset_scbf_compile_count() -> None:
    """The reference clears its pass's jit cache; the port holds none."""


def fused_compile_count() -> int:
    """The reference's jit-cache size of its fused chunk programs: here
    the fused round programs captured as CUDA graphs since the last
    reset (``fed.graphs.captures``; a CPU run captures none)."""
    return graphs.captures


def reset_fused_compile_count() -> None:
    """Set the count of captured round programs to 0 (the replays'
    count stays)."""
    graphs.captures = 0


def make_engine(kind: str, clients, batch_size: int, epochs: int, device,
                bucket: str = "pow2", pods: int = 1, mesh=None):
    """``mesh``: the batched engine's pod mesh (``BatchedEngine``)."""
    if kind not in ENGINES:
        raise ValueError(f"unknown engine {kind!r}; one of {sorted(ENGINES)}")
    return ENGINES[kind](clients, batch_size, epochs, device, bucket=bucket,
                         pods=pods, mesh=mesh)
