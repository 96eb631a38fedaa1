"""SCBF / FedAvg driver — the paper's Algorithm 1 (port of
``repro.core.scbf``, per-round path).

One global loop:
  1. the sync scheduler picks the reporting cohort;
  2. the engine (``FedConfig.engine``: ``batched`` by default, all
     participants as one slot-stacked pass; ``sequential``, one client at
     a time) trains every participant and channel-selects its delta
     (``layer_scores`` → α-quantile → exact edge mask, the score-and-mask
     pass running through the Hopper kernels on CUDA), then, with DP on
     (``ScbfConfig.dp_noise_multiplier > 0``), clips and noises each
     masked delta on its reveal masks before it is encoded;
  3. the strategy folds the uploads into the server:
     W <- W + Σ_k ΔW̃_k for SCBF, the example-weighted mean for FedAvg;
  4. (SCBFwP / FAwP, ``ScbfConfig.prune``) while the cumulative pruned
     fraction is below θ_total, prune θ of the server's remaining hidden
     neurons by APoZ on the validation set (``core.pruning.Pruner``, the
     counts from the apoz kernel): ``reshape`` slices the model,
     ``mask`` switches neurons off with device keep-masks and compacts
     once the budget is spent;
  5. AUC-ROC / AUC-PR on the test set, plus the upload bytes.

The run happens on ``device`` — ``None`` means CUDA, and without a CUDA
device the caller must ask for the CPU (``repro_torch.device``).  Matmuls
run in full fp32 (TF32 off), as the reference computes.

Randomness: one CPU ``torch.Generator`` seeded from ``TrainConfig.seed``
draws the initial weights and every epoch permutation (of the client's
shard on the sequential engine, of the padded shard n_max on the batched
one); with DP on, it then draws once the seed of a generator on the
run's device, which draws the DP noise (``fed.engine`` says in what
order).  Parity tests inject the reference's draws instead:
``init_params`` (numpy), ``perms`` (``(loop, client, epoch) -> index
array``) and ``dp_noise`` (``(loop, participant position, leaf shapes)
-> standard normals``, one array a leaf in ``comm.wire.flat_keys``
order).

DP accounting is the reference's: ε composes per *release*, so
``run_federated`` keeps a per-client release ledger and reports the worst
client's ε (RDP or the classic bound), or with ``dp_amplification`` the
tighter of that and the subsampled-Gaussian bound composed over rounds.

The fused round loop (``FedConfig.fuse_rounds`` = S > 1, on the batched
engine; ``_run_fused``) runs chunks of S sync rounds with the server sum
on the device and no host sync inside a chunk: each round is one replay
of a captured CUDA graph (an eager call on the CPU), the uploads are
encoded after the chunk, and evaluation happens at chunk boundaries.
The chunk's randomness is drawn before it in the per-round order, so the
trajectory is the per-round run's.  It falls back to the per-round loop
where the reference does: the sequential engine and reshape pruning.

Cross-device scenarios, as in the reference: ``FedConfig.mode="fedbuff"``
(buffered async rounds, each participant training from the server
version it started at), the simulated clock (deadline cuts that drop or
spill), seeded fault injection (client faults → ``seal`` → wire faults →
the admission gate), a norm bound that rejects or clips, and a round
quorum with retries — all planned on the host by
``fed.faults.Resilience``.  The fused loop folds the planned verdicts
into an admit mask and, after each chunk, runs the real gate on the
emitted payloads; a disagreement is a ``RuntimeError``.

The flight recorder, as in the reference: a run under
``repro_torch.obs.recording`` logs the reference's events (``run_start``,
``round``, ``fault_injected``, ``payload_rejected``, ``round_retried``,
``quorum_miss``, ``fedbuff_flush``, ``prune``, ``compact``, ``run_end``),
spans (``round``, ``fused_chunk``, ``encode``, ``eval``) and counters, and
collects the device telemetry (``ObsConfig.device_metrics`` collects it
without a recorder): each ``round`` event and ``LoopRecord.train_loss``
then carry the round's mean training loss, and the event its selected
channels and bytes by codec (``repro_torch.obs.metrics``), computed on the
device (inside the captured round when fused) and offloaded once a round
or a chunk.  ``TrainConfig.debug_checks`` runs the host-side checks of
``repro_torch.obs.checks`` on the offloaded values after each loop or
chunk.  Neither changes a parameter bit.

Pods (``FedConfig.pods`` > 1, or a ``mesh``): the run is one rank of a
``torch.distributed`` group whose world size is ``pods``
(``sharding.mesh.make_pod_mesh``), each rank on
``cuda:{LOCAL_RANK % device_count}`` (ranks may share a card).  The
batched engine splits every round's slots over the ranks
(``fed.engine.BatchedEngine``); everything else — the plan, the draws
(in the one-device order), the server state, SCBFwP's prune steps (K4 on
every rank, so the keep-masks stay replicated) and the evaluation — runs
alike on every rank, so every rank returns the same records, and the
uploads and the model are bitwise one device's.  Whether the run
collects its telemetry is agreed across the ranks.  The caller writes
files and events from rank 0 only (``launch.train``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import wire
from repro_torch.config import TrainConfig
from repro_torch.core import channels, privacy, pruning
from repro_torch.core.client import epoch_perms
from repro_torch.data.medical import (MedicalCohort, dirichlet_split,
                                      federated_split)
from repro_torch.device import resolve_device
from repro_torch.fed.clock import SimClock
from repro_torch.fed.cohort import fused_chunk_len
from repro_torch.fed.engine import make_engine
from repro_torch.fed.faults import (FaultInjector, Resilience,
                                    apply_payload_faults)
from repro_torch.fed.scheduler import make_scheduler
from repro_torch.fed.strategy import (AdmissionPolicy, RoundContribution,
                                      admit_payloads, make_strategy)
from repro_torch.comm import collectives
from repro_torch.sharding import mesh as meshes
from repro_torch.metrics.auc import auc_pr, auc_roc
from repro_torch.models.mlp_net import hidden_sizes, init_mlp, mlp_forward
from repro_torch.obs import checks as obschecks
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obstrace
from repro_torch.optim import schedules
from repro_torch.params import from_numpy, num_params

PermFn = Callable[[int, int, int], np.ndarray]
NoiseFn = Callable[[int, int, Sequence[Tuple[int, ...]]], Sequence[np.ndarray]]


@dataclass
class LoopRecord:
    loop: int
    auc_roc: float               # last-known when evaluated=False
    auc_pr: float
    upload_fraction: float       # fraction of params revealed this loop
    sparse_bytes: int            # what SCBF actually ships
    dense_bytes: int             # what FedAvg would ship for the same model
    wall_time: float             # seconds for the loop (train+select+update)
    flops_proxy: float           # ~params * examples
    hidden_sizes: Tuple[int, ...] = ()
    num_participants: int = 0    # clients whose updates arrived this loop
    epsilon: Optional[float] = None   # cumulative DP ε (None: DP off)
    evaluated: bool = True
    epsilon_unamplified: Optional[float] = None
    # mean training loss a participant, from the device telemetry (None
    # when collection was off this run)
    train_loss: Optional[float] = None
    wall_is_amortized: bool = False


@dataclass
class RunResult:
    method: str
    records: List[LoopRecord] = field(default_factory=list)
    dp_delta: Optional[float] = None  # δ of the reported (ε, δ); None: DP off
    final_params: Optional[Tuple] = None  # the trained global model
    telemetry: Optional[dict] = None

    @property
    def final(self) -> LoopRecord:
        return self.records[-1]

    @property
    def final_epsilon(self) -> Optional[float]:
        return self.records[-1].epsilon if self.records else None

    def best(self, key: str = "auc_roc") -> float:
        return max(getattr(r, key) for r in self.records)

    def total_time(self) -> float:
        return sum(r.wall_time for r in self.records)

    def total_upload_bytes(self) -> int:
        return sum(r.sparse_bytes for r in self.records)


def _evaluate(params, x: torch.Tensor, y: torch.Tensor, batch: int = 8192,
              neuron_masks=None) -> Tuple[float, float]:
    """(AUC-ROC, AUC-PR) of the model on (x, y), both on the run's device;
    one host copy at the end, inside the ``eval`` span.  ``neuron_masks``
    scores the masked model (mask-mode SCBFwP)."""
    with obstrace.span("eval", examples=int(x.shape[0])), torch.no_grad():
        scores = torch.cat([mlp_forward(params, x[s:s + batch],
                                        neuron_masks)
                            for s in range(0, x.shape[0], batch)])
        both = torch.stack([auc_roc(scores, y), auc_pr(scores, y)])
    roc, pr = both.tolist()
    return roc, pr


def _partition(cohort: MedicalCohort, train_cfg: TrainConfig):
    fed = train_cfg.fed
    if fed.partition == "dirichlet":
        return dirichlet_split(cohort.x_train, cohort.y_train,
                               train_cfg.scbf.num_clients,
                               alpha=fed.dirichlet_alpha,
                               seed=train_cfg.seed)
    if fed.partition == "iid":
        return federated_split(cohort.x_train, cohort.y_train,
                               train_cfg.scbf.num_clients,
                               seed=train_cfg.seed)
    raise ValueError(f"unknown partition {fed.partition!r}; iid|dirichlet")


def _lr_schedule(train_cfg: TrainConfig):
    if train_cfg.lr_schedule == "cosine":
        return schedules.cosine_decay(train_cfg.learning_rate,
                                      max(train_cfg.global_loops - 1, 1))
    return schedules.constant(train_cfg.learning_rate)


def _lr_table(train_cfg: TrainConfig) -> np.ndarray:
    """Host-side fp32 lr table for the whole run."""
    fn = _lr_schedule(train_cfg)
    steps = torch.arange(max(train_cfg.global_loops, 1))
    return fn(steps).numpy().astype(np.float32)


def _should_eval(loop: int, total_loops: int, eval_every: int) -> bool:
    """Evaluate every N loops, plus always the final loop."""
    return loop == total_loops - 1 or (loop + 1) % max(eval_every, 1) == 0


def check_slice(train_cfg: TrainConfig, method: str) -> None:
    """Refuse, before anything is built, what the reference refuses (its
    exception types and order)."""
    cfg, fed = train_cfg.scbf, train_cfg.fed
    if int(fed.fuse_rounds) < 1:
        raise ValueError(f"fuse_rounds must be >= 1, got {fed.fuse_rounds}")
    if method not in ("scbf", "fedavg"):
        raise ValueError(method)
    if cfg.dp_noise_multiplier > 0 and method != "scbf":
        raise ValueError("dp_noise_multiplier applies to the sparse scbf "
                         "upload path; method='fedavg' ships full weights "
                         "with no DP mechanism — refusing to run with a "
                         "privacy guarantee silently off")
    if cfg.prune and cfg.prune_impl not in ("reshape", "mask"):
        raise ValueError(f"unknown prune_impl {cfg.prune_impl!r}; "
                         "one of ('reshape', 'mask')")
    mask_prune = cfg.prune and cfg.prune_impl == "mask"
    if mask_prune and method != "scbf":
        raise ValueError("prune_impl='mask' threads neuron keep-masks "
                         "through the sparse scbf pipeline; "
                         "method='fedavg' (FAwP) prunes by reshaping — "
                         "use prune_impl='reshape'")
    if fed.mode == "fedbuff":
        if method != "scbf":
            raise ValueError("fedbuff buffers sparse scbf uploads; "
                             "method must be 'scbf'")
        if cfg.prune and not mask_prune:
            raise ValueError("reshape pruning changes shapes under "
                             "in-flight clients; fedbuff needs "
                             "prune_impl='mask' (run-constant geometry)")
    faults_on = fed.faults.enabled
    spill_mode = fed.clock.enabled and fed.clock.deadline_action == "spill"
    if faults_on and method != "scbf":
        raise ValueError(
            "fault injection corrupts the sparse scbf upload pipeline; "
            "method='fedavg' ships full weight pytrees with no wire "
            "payload to corrupt — refusing a silently-inert fault plan")
    if fed.max_update_norm > 0 and method != "scbf":
        raise ValueError(
            "max_update_norm bounds sparse scbf payload norms; the "
            "fedavg path has no payload to gate — refusing to run with "
            "a configured bound silently off")
    if fed.min_valid_participants > 0 and fed.mode == "fedbuff":
        raise ValueError(
            "round-level quorum retries re-plan the round; fedbuff "
            "planning mutates in-flight client state on every plan "
            "call, so a replanned attempt would corrupt it — "
            "min_valid_participants needs sync mode")
    if spill_mode and cfg.prune:
        raise ValueError(
            "deadline spilling delivers payloads emitted against an "
            "earlier round's keep-masks; pruning changes the masks "
            "between emission and arrival, so the spilled indices "
            "would remap wrong — use deadline_action='drop' with "
            "pruning")


def _check_dp(train_cfg: TrainConfig, method: str, scheduler) -> float:
    """The reference's DP refusals, once the scheduler exists; returns
    the amplification's sampling rate q (1.0 without amplification)."""
    cfg, fed = train_cfg.scbf, train_cfg.fed
    if cfg.dp_noise_multiplier < 0:
        raise ValueError(
            f"dp_noise_multiplier must be >= 0, got "
            f"{cfg.dp_noise_multiplier}: the DP gate is "
            f"'dp_noise_multiplier > 0', so a negative value would "
            f"silently run without DP while looking configured")
    if not (method == "scbf" and cfg.dp_noise_multiplier > 0):
        return 1.0
    # an unknown accountant, or a classic bound outside its eps <= 1
    # domain, fails before training, not after it
    privacy.epsilon_for(cfg.dp_noise_multiplier, cfg.dp_delta, loops=1,
                        accountant=cfg.dp_accountant)
    if not cfg.dp_amplification:
        return 1.0
    if fed.clock.enabled:
        raise ValueError(
            "subsampled amplification assumes a uniform i.i.d. "
            "per-round sample; the simulated clock restricts "
            "sampling to currently-available clients (diurnal "
            "churn), which is not one — refusing to report a "
            "silently-wrong amplified ε")
    if fed.mode == "fedbuff":
        raise ValueError(
            "subsampled amplification assumes an i.i.d. per-round "
            "sample; fedbuff participation is not one — refusing to "
            "report a silently-wrong amplified ε")
    if cfg.dp_accountant != "rdp":
        raise ValueError("dp_amplification is an RDP analysis; it "
                         f"composes on the subsampled RDP curve, so "
                         f"dp_accountant={cfg.dp_accountant!r} cannot "
                         "back the reported ε — use 'rdp'")
    # q from the scheduler's own cohort size, so the reported
    # amplification matches the sampling performed
    q = min(1.0, scheduler.max_participants / cfg.num_clients)
    privacy.amplified_epsilon_for(cfg.dp_noise_multiplier, q, cfg.dp_delta,
                                  rounds=1)  # fail fast
    return q


def _check_fused(fed, faults_on: bool) -> None:
    """The reference's refusals of the fused loop: admission verdicts it
    cannot plan would diverge from what the device folded in."""
    if fed.max_update_norm > 0 and not faults_on:
        raise ValueError(
            "the fused path cannot run a host-side norm gate over "
            "its on-device aggregation; arm the fault model "
            "(FaultConfig.enabled) so admission is planned, or use "
            "fuse_rounds=1")
    if faults_on and fed.max_update_norm > 0 \
            and fed.norm_action == "clip":
        raise ValueError(
            "norm_action='clip' rescales admitted payloads on the "
            "host; the fused path aggregates the raw on-device "
            "deltas, so clipping cannot take effect — use "
            "norm_action='reject' or fuse_rounds=1")
    if faults_on and fed.faults.poison_rate > 0 \
            and not (fed.max_update_norm > 0
                     and fed.norm_action == "reject"):
        raise ValueError(
            "poisoned (norm-inflated) updates are only excludable "
            "at plan time when a reject-mode norm gate is armed "
            "(max_update_norm > 0, norm_action='reject'); without "
            "one the fused path would fold poison into the model — "
            "arm the gate or use fuse_rounds=1")


def _finish_telemetry(result: "RunResult") -> None:
    """Fold the recorder's counters into ``result.telemetry`` and emit
    the closing ``run_end`` event (nothing when not recording)."""
    rec = obstrace.get_recorder()
    if rec is None:
        return
    tel = dict(rec.counters)
    result.telemetry = tel
    rec.event("run_end", **tel)


def _round_event_fields(rec: LoopRecord, plan, pruner, dm=None,
                        eps_step=None) -> dict:
    """The ``round`` event's fields (the reference's schema), one function
    for both loop shapes: the record's scalars, the scheduler's telemetry,
    the keep-mask density and, when collection was on, the round's device
    metrics ``dm`` (``train_loss``, ``selected``, ``codec_bytes`` where
    the engine gives them)."""
    out = {
        "loop": rec.loop, "participants": rec.num_participants,
        "upload_fraction": round(rec.upload_fraction, 6),
        "sparse_bytes": rec.sparse_bytes, "dense_bytes": rec.dense_bytes,
        "wall": round(rec.wall_time, 6),
        "wall_is_amortized": rec.wall_is_amortized,
        "hidden": list(rec.hidden_sizes),
        "evaluated": rec.evaluated,
    }
    if rec.epsilon is not None:
        out["epsilon"] = rec.epsilon
        if eps_step is not None:
            out["epsilon_step"] = eps_step
    if pruner is not None:
        out["keep_density"] = round(
            sum(pruner.hidden_sizes()) / max(pruner.original_hidden, 1), 6)
    if plan is not None:
        out.update(plan.telemetry())
    if dm:
        for k in ("train_loss", "selected", "codec_bytes"):
            if dm.get(k) is not None:
                out[k] = dm[k]
    return out


def run_federated(cohort: MedicalCohort,
                  train_cfg: TrainConfig,
                  method: str = "scbf",
                  mlp_features: Optional[Tuple[int, ...]] = None,
                  verbose: bool = False,
                  device=None,
                  init_params: Optional[Sequence[dict]] = None,
                  perms: Optional[PermFn] = None,
                  dp_noise: Optional[NoiseFn] = None,
                  engine: Optional[str] = None, mesh=None) -> RunResult:
    """Run one federated experiment: method "scbf" | "fedavg", with
    pruning controlled by ``train_cfg.scbf.prune`` (→ SCBFwP / FAwP).

    ``device``: None → cuda (raises without one); "cpu" on request.
    ``init_params``: numpy layer dicts to start from (else He init on the
    run's generator).  ``perms(loop, client, epoch)``: the permutation of
    that client's shard (batched engine: of the padded shard) for that
    epoch (else drawn on the generator).  ``dp_noise(loop, i, shapes)``:
    the standard normals of the round's i-th participant, one array a
    leaf of ``shapes`` (else drawn on the run's device generator).
    ``engine`` overrides ``train_cfg.fed.engine`` ("batched" |
    "sequential").  ``mesh``: the pod mesh of the run's rank (by default
    ``make_pod_mesh(fed.pods)`` when ``fed.pods`` > 1, which needs an
    initialised group of that world size); given with ``pods`` = 1 it
    runs the pod path on a group of one.

    ``LoopRecord.wall_time`` is the round span — plan, local training,
    selection, encoding (the host then holds the payloads), the fault
    pipeline and the gate, the server update and the prune step,
    synchronised with the device — and leaves evaluation out; a fused
    run records each round of a chunk as the chunk's wall over its
    rounds (``wall_is_amortized``).
    """
    check_slice(train_cfg, method)
    dev = resolve_device(device)
    cfg, fed = train_cfg.scbf, train_cfg.fed
    if mesh is None and fed.pods > 1 and (engine or fed.engine) == "batched":
        mesh = meshes.make_pod_mesh(fed.pods, device=dev)
    if mesh is not None:
        dev = meshes.rank_device(dev)
    # the reference computes in full fp32: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock_on, faults_on = fed.clock.enabled, fed.faults.enabled
    spill_mode = clock_on and fed.clock.deadline_action == "spill"
    gen = torch.Generator().manual_seed(train_cfg.seed)

    feats = mlp_features or (cohort.num_features, 256, 64, 1)
    params = from_numpy(init_params, dev) if init_params is not None \
        else init_mlp(feats, gen, dev)
    clients = _partition(cohort, train_cfg)
    eng = make_engine(engine or fed.engine, clients,
                      train_cfg.local_batch_size,
                      train_cfg.local_epochs, dev, bucket=fed.bucket,
                      pods=fed.pods, mesh=mesh)
    clock = SimClock(cfg.num_clients, fed.clock, seed=train_cfg.seed) \
        if clock_on else None
    scheduler = make_scheduler(fed, cfg.num_clients, train_cfg.seed,
                               clock=clock)
    injector = FaultInjector(cfg.num_clients, fed.faults) \
        if faults_on else None
    # the gate arms whenever payloads can be hostile (fault injection) or
    # a norm bound is configured; otherwise the fault-free path runs
    policy = AdmissionPolicy(max_update_norm=fed.max_update_norm,
                             norm_action=fed.norm_action) \
        if (faults_on or fed.max_update_norm > 0) else None
    strategy = make_strategy(method, cfg, fed, policy=policy)
    resil = Resilience(scheduler, clock, injector, fed)
    if fed.min_valid_participants > 0 and \
            fed.min_valid_participants > scheduler.max_participants:
        raise ValueError(
            f"min_valid_participants={fed.min_valid_participants} can "
            f"never be met: the scheduler samples at most "
            f"{scheduler.max_participants} clients per round — every "
            "round would exhaust its retries and miss quorum")
    state = strategy.init(params)
    # fedbuff: the versions in-flight clients train from; spill: the
    # rounds spilled clients were sampled in (pruned to those referenced)
    history = {0: params} if fed.mode == "fedbuff" else None
    round_history = {0: params} if spill_mode else None
    lrs = _lr_table(train_cfg)
    amp_q = _check_dp(train_cfg, method, scheduler)
    x_test = torch.as_tensor(cohort.x_test).to(dev)
    y_test = torch.as_tensor(cohort.y_test).to(dev)
    pruner = None
    if cfg.prune:
        # fedbuff keeps full-geometry stale versions alive for its
        # in-flight clients, so mask mode's one-shot compaction is off
        pruner = pruning.Pruner(params, cohort.x_val,
                                prune_rate=cfg.prune_rate,
                                prune_total=cfg.prune_total,
                                impl=cfg.prune_impl,
                                compact=cfg.prune_compact
                                and fed.mode != "fedbuff")
    dp_on = method == "scbf" and cfg.dp_noise_multiplier > 0
    amplify = dp_on and cfg.dp_amplification
    # ε composes per release: the spend is tracked per client and the
    # worst (most-releasing) client reported
    dp_releases = np.zeros(cfg.num_clients, dtype=np.int64)
    dp_gen = None
    if dp_on and dp_noise is None:
        dp_gen = torch.Generator(device=dev)
        dp_gen.manual_seed(int(torch.randint(2 ** 62, (1,), generator=gen)))
    result = RunResult(method=method + ("wp" if cfg.prune else ""),
                       dp_delta=cfg.dp_delta if dp_on else None)
    # the device telemetry collects under an active recorder or on request
    collect = train_cfg.obs.device_metrics or \
        obstrace.get_recorder() is not None
    if mesh is not None:
        collect = collectives.agree_any(collect, mesh)
    obstrace.event(
        "run_start", method=result.method, loops=train_cfg.global_loops,
        clients=cfg.num_clients, engine=eng.name,
        fuse_rounds=int(fed.fuse_rounds), mode=fed.mode,
        dp_sigma=(cfg.dp_noise_multiplier * cfg.dp_clip_norm)
        if dp_on else None,
        prune=cfg.prune, prune_impl=cfg.prune_impl if cfg.prune else None)

    def _epsilons(loop: int):
        """(epsilon, epsilon_unamplified) for the record of ``loop``."""
        if not dp_on:
            return None, None
        un = privacy.epsilon_for(cfg.dp_noise_multiplier, cfg.dp_delta,
                                 loops=int(dp_releases.max()),
                                 accountant=cfg.dp_accountant)
        if amplify:
            # both are valid upper bounds (amplified over rounds,
            # unamplified over per-client releases): report the tighter
            amp = privacy.amplified_epsilon_for(
                cfg.dp_noise_multiplier, amp_q, cfg.dp_delta,
                rounds=loop + 1)
            return min(amp, un), un
        return un, None

    init_model = params
    known = {"roc": None, "pr": None}

    def _metrics(params_now, do_eval: bool, nmasks=None):
        """(auc_roc, auc_pr, evaluated) — last-known when not evaluating
        (the initial model, scored lazily, before any evaluation).
        ``nmasks`` scores the masked model (mask-mode SCBFwP)."""
        if do_eval:
            known["roc"], known["pr"] = _evaluate(params_now, x_test, y_test,
                                                  neuron_masks=nmasks)
            return known["roc"], known["pr"], True
        if known["roc"] is None:
            known["roc"], known["pr"] = _evaluate(init_model, x_test, y_test)
        return known["roc"], known["pr"], False

    prev_eps = 0.0

    def _record(loop: int, plan, emitted, wire_payloads, up_params,
                params_now, wall: float, do_eval: bool,
                amortized: bool = False, dm=None, check_at=None):
        """Append loop ``loop``'s record and ``round`` event (and print it
        when verbose): its uploads (scbf: ``emitted``, the (payloads,
        stats), and ``wire_payloads``, what crossed the network, replays
        included; fedavg: ``up_params`` whole from each participant), the
        model after the loop, the loop's wall and its device metrics
        ``dm`` (None: not collected).  ``check_at``: the debug checks'
        boundary label, run after the record is appended.  All of it,
        the evaluation included, inside the ``record`` span."""
        nonlocal prev_eps
        with obstrace.span("record"):
            P = plan.num_participants
            if method == "scbf":
                payloads, stats = emitted
                up_frac = float(np.mean([st.upload_fraction
                                         for st in stats])) \
                    if stats else 0.0
                sparse_bytes = int(sum(p.nbytes for p in wire_payloads))
                dense_bytes = int(sum(p.dense_nbytes for p in payloads))
            else:
                up_frac = 1.0 if P else 0.0
                dense_bytes = num_params(up_params) * 4 * P
                sparse_bytes = dense_bytes
            roc, pr, evaluated = _metrics(
                params_now, do_eval,
                pruner.masks if pruner is not None else None)
            if pruner is not None:
                # the effective model, whether neurons are masked or gone
                n_params = pruner.effective_param_count(params_now)
                hidden = pruner.hidden_sizes()
            else:
                n_params = num_params(params_now)
                hidden = hidden_sizes(params_now)
            eps, eps_un = _epsilons(loop)
            rec = LoopRecord(
                loop=loop, auc_roc=roc, auc_pr=pr, upload_fraction=up_frac,
                sparse_bytes=sparse_bytes, dense_bytes=dense_bytes,
                wall_time=wall,
                flops_proxy=float(n_params) * cohort.x_train.shape[0],
                hidden_sizes=hidden, num_participants=P, epsilon=eps,
                evaluated=evaluated, epsilon_unamplified=eps_un,
                train_loss=dm.get("train_loss") if dm else None,
                wall_is_amortized=amortized)
            result.records.append(rec)
            if check_at is not None:
                # host-side, on values already offloaded: the device
                # program is the same with the checks on or off
                obschecks.verify_round(params_now, dm, where=check_at)
            obstrace.event("round", **_round_event_fields(
                rec, plan, pruner, dm,
                eps_step=(eps - prev_eps) if eps is not None else None))
            prev_eps = eps if eps is not None else 0.0
            if verbose:
                print(f"[{result.method}] loop {loop:02d} "
                      f"auc_roc={roc:.4f} auc_pr={pr:.4f} "
                      f"upload={up_frac:.2%} hidden={hidden} clients={P} "
                      f"t={wall:.2f}s"
                      + ("" if evaluated else " (metrics carried)"))

    draws = _RunDraws(train_cfg, eng, gen, dp_gen, perms, dp_noise)
    # the fused loop needs sync planning, run-constant shapes (no reshape
    # pruning), the batched engine and no spilling; else per round
    use_fused = (int(fed.fuse_rounds) > 1 and fed.mode == "sync"
                 and (not cfg.prune or cfg.prune_impl == "mask")
                 and eng.name == "batched" and not spill_mode)
    if use_fused:
        _check_fused(fed, faults_on)
        if min(int(fed.fuse_rounds), train_cfg.global_loops) > 1:
            # the first chunk's records carry the initial model's
            # metrics: evaluate it now, as the reference does
            _metrics(params, True,
                     pruner.masks if pruner is not None else None)
        result.final_params = _run_fused(
            train_cfg, method, eng, resil, state, lrs, draws,
            dp_releases, _record, pruner, injector, policy, collect)
        _finish_telemetry(result)
        return result

    for loop in range(train_cfg.global_loops):
        with obstrace.span("round", loop=loop) as sp:
            lr = float(lrs[loop])
            ar = resil.plan_round(loop, state.version)
            plan = ar.plan
            part = plan.participants
            P = plan.num_participants
            if method == "scbf":
                # aborted quorum attempts trained and uploaded before the
                # server discarded them: each is a distinct release, and
                # charging it errs the way DP accounting must
                for aborted in ar.aborted_arrivers:
                    if aborted.size:
                        dp_releases[np.asarray(aborted)] += 1  # privlint: disable=PL004
            round_perms = draws.round_perms(loop, part)
            payloads, stats, wire_payloads, dm = [], [], [], None
            if P:
                if fed.mode == "fedbuff":
                    params_for = [history[state.version - int(tau)]
                                  for tau in plan.staleness]
                elif spill_mode:
                    # a spilled arrival trained from the round it was
                    # sampled in (staleness = rounds in flight)
                    params_for = [round_history[loop - int(tau)]
                                  for tau in plan.staleness]
                else:
                    params_for = state.params
                if method == "scbf":
                    nmasks = pruner.masks if pruner is not None else None
                    keep_eff = pruner.emission_keep if pruner is not None \
                        else None
                    # the batched engine takes the round's sampled-
                    # quantile draws as the fused loop does; the
                    # sequential engine draws them a client at a time on
                    # the same generator
                    sampled = {} if eng.name != "batched" or not \
                        _sampled(method, state.params) else dict(
                            sample_idx=draws.sample_idx(
                                state.params, P,
                                None if nmasks is None else pruner.keep))
                    out = eng.scbf_round(
                        params_for, part, lr, round_perms, cfg,
                        generator=gen, nmasks=nmasks, keep=keep_eff,
                        noise=draws.injected_noise(loop, state.params, P)
                        if dp_on else None,
                        dp_generator=dp_gen, collect=collect, **sampled)
                    payloads, stats = out[:2]
                    dm = out[2] if collect else None
                    dp_releases[np.asarray(part)] += 1
                    wire_payloads = payloads
                    nx = eng.counts[np.asarray(part)]
                    stal = np.asarray(plan.staleness)
                    cl = np.asarray(part)
                    if injector is not None and payloads:
                        # client faults → seal → wire faults → replays
                        wire_payloads, dup_src = apply_payload_faults(
                            payloads, cl, ar.corrupt, ar.duplicated,
                            loop, ar.attempts - 1, fed.faults,
                            fed.max_update_norm)
                        if dup_src:
                            nx = np.concatenate([nx, nx[dup_src]])
                            stal = np.concatenate([stal, stal[dup_src]])
                            cl = np.concatenate([cl, cl[dup_src]])
                    # mask mode: the gate admits the effective-geometry
                    # wire payloads, which are expanded to the server's
                    # geometry just before they are applied
                    expand = None
                    if keep_eff is not None:
                        expand = (lambda ps, _k=keep_eff,
                                  _ref=state.params:
                                  pruning.expand_payloads(ps, _k, _ref))
                    contrib = RoundContribution(
                        num_examples=nx, staleness=stal,
                        payloads=wire_payloads, clients=cl, expand=expand)
                else:
                    out = eng.fedavg_round(params_for, part, lr,
                                           round_perms, collect=collect)
                    client_params, counts = out[:2]
                    dm = out[2] if collect else None
                    contrib = RoundContribution(
                        num_examples=counts, staleness=plan.staleness,
                        client_params=client_params,
                        clients=np.asarray(part))
                if ar.quorum_ok:
                    state = strategy.aggregate(state, contrib)
                # a terminal quorum miss: the cohort trained and uploaded,
                # but the server does not step on a sub-quorum round
            params = up_params = state.params
            if fed.mode == "fedbuff":
                history[state.version] = params
                live = scheduler.referenced_versions() | {state.version}
                history = {v: p for v, p in history.items() if v in live}
            elif spill_mode:
                round_history[loop + 1] = params
                live = scheduler.referenced_rounds() | {loop + 1}
                round_history = {r: p for r, p in round_history.items()
                                 if r in live}

            # ---- pruning (SCBFwP / FAwP), inside the loop's wall ----
            if pruner is not None and pruner.active:
                # reshape: returns the sliced params; mask: updates the
                # keep-masks and returns params unchanged
                params = pruner.step(params)
                obstrace.event("prune", loop=loop,
                               hidden=list(pruner.hidden_sizes()))
            if pruner is not None and pruner.should_compact:
                params = pruner.compact(params)   # mask mode, budget spent
                obstrace.event("compact", loop=loop,
                               hidden=list(pruner.hidden_sizes()))
            state = dataclasses.replace(state, params=params)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        _record(loop, plan, (payloads, stats), wire_payloads, up_params,
                params, sp.elapsed,
                _should_eval(loop, train_cfg.global_loops,
                             train_cfg.eval_every), dm=dm,
                check_at=f"loop {loop}" if train_cfg.debug_checks
                else None)
    result.final_params = state.params
    _finish_telemetry(result)
    return result


def _sampled(method: str, params) -> bool:
    """Whether a round's selection takes the sampled quantile path."""
    return method == "scbf" and channels.num_channels(
        [layer["b"] for layer in params]) > channels.MAX_MATERIALIZED


class _RunDraws:
    """A run's randomness, in the order the rounds draw it: for each round
    in turn its epoch permutations and then the sampled quantile path's
    indices on the run's generator, and its DP normals on the device
    generator (or the injected ``perms`` / ``dp_noise``).  The per-round
    loop draws a round at a time, the fused loop a chunk's rounds before
    the chunk."""

    def __init__(self, train_cfg: TrainConfig, eng, gen, dp_gen,
                 perms: Optional[PermFn], dp_noise: Optional[NoiseFn]):
        self.train_cfg, self.eng, self.gen, self.dp_gen = (train_cfg, eng,
                                                           gen, dp_gen)
        self.perms, self.dp_noise = perms, dp_noise

    def round_perms(self, loop: int, part) -> List[list]:
        epochs = self.train_cfg.local_epochs
        if self.perms is not None:
            return [[self.perms(loop, int(k), e) for e in range(epochs)]
                    for k in part]
        return [epoch_perms(self.eng.perm_length(k), epochs, self.gen)
                for k in part]

    def sample_idx(self, params, p_count: int, keep=None) -> np.ndarray:
        """(slots, layers, n) int64: the indices the per-round pass draws
        for its bucket of slots (one device's bucket, on pods too) —
        among the kept neurons under mask-mode pruning (``keep``, host
        index sets of the hidden layers)."""
        sizes = [int(layer["w"].shape[-1]) for layer in params]
        weights = None
        if keep is not None:
            weights = [torch.ones(m) for m in sizes]
            for l, kept in enumerate(keep):
                weights[l] = torch.zeros(sizes[l])
                weights[l][torch.from_numpy(np.asarray(kept))] = 1.0
        out = np.zeros((self.eng.draw_slots(p_count) if p_count else 0,
                        len(sizes), channels.NUM_SAMPLES), np.int64)
        for k in range(out.shape[0]):
            for l, idx in enumerate(channels.sample_channels(
                    sizes, self.gen, weights=weights)):
                out[k, l] = idx.numpy()
        return out

    def injected_noise(self, loop: int, params, p_count: int):
        """Round ``loop``'s injected DP normals (``dp_noise``), one array a
        leaf for each participant; None when they are not injected."""
        if self.dp_noise is None:
            return None
        shapes = [tuple(params[l][k].shape) for l, k in wire.flat_keys(params)]
        return [self.dp_noise(loop, i, shapes) for i in range(p_count)]

    def noise(self, loop: int, params, p_count: int) -> List[torch.Tensor]:
        """Round ``loop``'s DP normals, one (P, *leaf) tensor a leaf (P = 0
        for an empty round, which draws nothing)."""
        if not p_count:
            return [torch.zeros((0, *params[l][k].shape),
                                device=self.eng.device)
                    for l, k in wire.flat_keys(params)]
        return self.eng.draw_noise(params, p_count,
                                   self.injected_noise(loop, params,
                                                       p_count),
                                   self.dp_gen)


def _run_fused(train_cfg: TrainConfig, method: str, eng, resil: Resilience,
               state, lrs: np.ndarray, draws: _RunDraws,
               dp_releases: np.ndarray, record, pruner=None, injector=None,
               policy=None, collect: bool = False):
    """The fused round loop: chunks of S sync rounds with no host sync
    inside (port of the reference's ``_run_fused``).

    Each chunk is planned by ``resil.plan_round`` a round at a time (the
    per-round loop's sequence: the same participation, faults, clock and
    quorum), its randomness drawn in the per-round order (``_RunDraws``)
    and its lr values sliced from the table, and every host→device copy
    made, in ``eng.prepare_fused_plan`` — with the plan's admit mask, the
    slots the gate will admit; then each round — train → delta → select
    → DP → validity zeroing → the admitted slots' ``scbf_sum_step`` (or
    ``fedavg_step``) — replays the captured round on the device.  The
    uploads are encoded once a chunk, after it
    (``eng.emit_fused_payloads``), so the per-round byte accounting is
    the per-round path's; then the fault pipeline and the real admission
    gate run on them, and a verdict that differs from the plan is a
    ``RuntimeError``.  Evaluation happens at chunk boundaries only; the
    other records carry the last-known AUC with ``evaluated=False``, and
    every record's wall is the chunk's over its rounds
    (``wall_is_amortized``).

    Mask-mode SCBFwP (``pruner``): the keep-masks are an input of the
    round; while pruning is still removing neurons the chunks are one
    round long (``fused_chunk_len``), so APoZ and the mask update at each
    chunk boundary land at the per-round cadence, and compaction follows
    the last step.  A run captures at most two rounds a shape: the
    masked full geometry and the compacted one.

    ``collect``: each captured round also computes its telemetry carry
    (the effective leaf sizes of mask mode a device input of the plan),
    and the chunk's carries reach the host in one copy after the
    emission; a collecting run captures its own rounds (``collect`` is
    part of the program's key).  ``debug_checks`` verifies the params
    and the offloaded metrics after each chunk, on the host.  ``record``
    appends a loop's record (``run_federated``'s ``_record``); returns
    the final params.
    """
    cfg, fed = train_cfg.scbf, train_cfg.fed
    dev = eng.device
    S = int(fed.fuse_rounds)
    B = eng.fused_num_slots(resil.scheduler.max_participants)
    total_loops = train_cfg.global_loops
    dp_on = method == "scbf" and cfg.dp_noise_multiplier > 0
    loop0 = 0
    while loop0 < total_loops:
        prune_active = pruner is not None and pruner.active
        chunk = fused_chunk_len(total_loops - loop0, S, prune_active)
        with obstrace.span("fused_chunk", loop0=loop0, rounds=chunk) as sp:
            with obstrace.span("plan"):
                ars = [resil.plan_round(loop0 + i, state.version)
                       for i in range(chunk)]
                plans = [ar.plan for ar in ars]
                params = state.params
                nmasks = pruner.masks if pruner is not None else None
                sampled = _sampled(method, params)
                parts, rperms, wts, noise, samples = [], [], [], [], []
                for r, (ar, plan) in enumerate(zip(ars, plans)):
                    part, P = plan.participants, plan.num_participants
                    parts.append(part)
                    rperms.append(draws.round_perms(loop0 + r, part) if P
                                  else [])
                    if sampled:
                        samples.append(draws.sample_idx(
                            params, P,
                            None if nmasks is None else pruner.keep))
                    if dp_on:
                        noise.append(draws.noise(loop0 + r, params, P))
                    if method == "fedavg":
                        if P and ar.quorum_ok:
                            n = eng.counts[np.asarray(part)].astype(np.float64)
                            wts.append((n / n.sum()).astype(np.float32))
                        else:
                            # a quorum-missed round must not step: all-zero
                            # weights pass the model through bitwise
                            wts.append(np.zeros(P, np.float32))
                keep_eff = pruner.emission_keep if pruner is not None else None
                fplan = eng.prepare_fused_plan(
                    parts, lrs[loop0:loop0 + chunk], rperms, horizon=chunk,
                    num_slots=B, weights=wts if method == "fedavg" else None,
                    noise=noise if dp_on else None,
                    sample_idx=samples if sampled else None,
                    admit=[ar.admit_mask() for ar in ars] if resil.active
                    else None,
                    eff_sizes=obsm.effective_leaf_sizes(params, keep_eff)
                    if collect and method == "scbf" and keep_eff is not None
                    else None)
            new_params, emitted, round_metrics = eng.run_fused_chunk(
                method, params, fplan, cfg, nmasks=nmasks, keep=keep_eff,
                collect=collect)
            # a round bumps the version iff it met quorum and admitted a
            # slot: the per-round gate's rule
            applied = sum(1 for ar in ars
                          if ar.quorum_ok and bool(ar.admit_mask().any()))
            state = dataclasses.replace(state, params=new_params,
                                        version=state.version + applied)
            if train_cfg.debug_checks:
                # host-side, on the values the chunk already offloaded
                obschecks.verify_round(state.params, round_metrics,
                                       where=f"chunk@loop {loop0}")
            if prune_active:
                # a one-round chunk: APoZ on the device, the mask update
                # on the host, at the per-round cadence
                pruner.step(state.params)
                obstrace.event("prune", loop=loop0,
                               hidden=list(pruner.hidden_sizes()))
                if pruner.should_compact:
                    state = dataclasses.replace(
                        state, params=pruner.compact(state.params))
                    obstrace.event("compact", loop=loop0,
                                   hidden=list(pruner.hidden_sizes()))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wall_each = sp.elapsed / chunk

        for r, (ar, plan) in enumerate(zip(ars, plans)):
            loop = loop0 + r
            P = plan.num_participants
            payloads, _ = emitted[r]
            wire_payloads = payloads
            if method == "scbf":
                # aborted quorum attempts are distinct uploads
                for aborted in ar.aborted_arrivers:
                    if aborted.size:
                        dp_releases[np.asarray(aborted)] += 1  # privlint: disable=PL004
                if injector is not None and payloads:
                    wire_payloads = _gate_emitted(state, ar, payloads, loop,
                                                  fed, policy)
                if P:
                    dp_releases[np.asarray(plan.participants)] += 1
            dm = round_metrics[r] if round_metrics is not None and P \
                else None
            record(loop, plan, emitted[r], wire_payloads, state.params,
                   state.params, wall_each, r == chunk - 1 and _should_eval(
                       loop, total_loops, train_cfg.eval_every),
                   amortized=True, dm=dm)
        loop0 += chunk
    return state.params


def _gate_emitted(state, ar, payloads, loop: int, fed, policy):
    """The fault pipeline and the real admission gate on a fused round's
    emitted payloads: the events and counters of the per-round path, and
    the gate's verdicts held against the plan the device folded in (a
    difference is a ``RuntimeError``).  Returns the wire payloads."""
    cl = np.asarray(ar.plan.participants)
    wire_payloads, dup_src = apply_payload_faults(
        payloads, cl, ar.corrupt, ar.duplicated, loop, ar.attempts - 1,
        fed.faults, fed.max_update_norm)
    if ar.quorum_ok:
        if dup_src:
            cl = np.concatenate([cl, cl[dup_src]])
        gate = RoundContribution(
            num_examples=np.zeros(len(wire_payloads), np.int64),
            staleness=np.zeros(len(wire_payloads), np.int64),
            payloads=wire_payloads, clients=cl)
        _, kept_idx = admit_payloads(state, gate, policy)
        planned = {i for i in range(ar.plan.num_participants)
                   if not ar.will_reject[i]}
        if set(kept_idx) != planned:
            raise RuntimeError(
                f"fused admission mismatch at loop {loop}: the device "
                f"folded slots {sorted(planned)} but the admission gate "
                f"admitted {sorted(kept_idx)} — an update failed a gate "
                "the planner could not predict (e.g. a natural nonfinite "
                "or norm violation); rerun with fuse_rounds=1")
    return wire_payloads
