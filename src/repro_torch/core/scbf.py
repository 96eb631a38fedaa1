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

Pod sharding, FedBuff, the simulated clock, fault injection, the
admission gate and the flight recorder are not ported yet; configs that
ask for them raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import time
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
from repro_torch.fed.cohort import fused_chunk_len
from repro_torch.fed.engine import make_engine
from repro_torch.fed.scheduler import SyncScheduler
from repro_torch.fed.strategy import RoundContribution, make_strategy
from repro_torch.metrics.auc import auc_pr, auc_roc
from repro_torch.models.mlp_net import hidden_sizes, init_mlp, mlp_forward
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
    one host copy at the end.  ``neuron_masks`` scores the masked model
    (mask-mode SCBFwP)."""
    with torch.no_grad():
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
    """Refuse what the reference refuses, and what the port does not run
    yet, naming its ROADMAP item."""
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
    if cfg.dp_noise_multiplier < 0:
        raise ValueError(f"dp_noise_multiplier must be >= 0, got "
                         f"{cfg.dp_noise_multiplier}: the DP gate is "
                         f"'dp_noise_multiplier > 0', so a negative value "
                         f"would silently run without DP while looking "
                         f"configured")
    if cfg.prune and cfg.prune_impl not in ("reshape", "mask"):
        raise ValueError(f"unknown prune_impl {cfg.prune_impl!r}; "
                         "one of ('reshape', 'mask')")
    if cfg.prune and cfg.prune_impl == "mask" and method != "scbf":
        raise ValueError("prune_impl='mask' threads neuron keep-masks "
                         "through the sparse scbf pipeline; "
                         "method='fedavg' (FAwP) prunes by reshaping — "
                         "use prune_impl='reshape'")
    todo = [
        (fed.pods != 1, "pod sharding is ROADMAP A15"),
        (fed.mode != "sync", f"mode={fed.mode!r}: fedbuff is ROADMAP A11"),
        (fed.clock.enabled, "the simulated clock is ROADMAP A11"),
        (fed.faults.enabled, "fault injection is ROADMAP A11"),
        (fed.max_update_norm > 0, "the admission gate is ROADMAP A11"),
        (fed.min_valid_participants > 0,
         "min_valid_participants (round quorum) is ROADMAP A11"),
        (train_cfg.debug_checks, "debug_checks is ROADMAP A12"),
        (train_cfg.obs.device_metrics,
         "device metrics (the flight recorder) are ROADMAP A12"),
    ]
    for cond, what in todo:
        if cond:
            raise NotImplementedError(f"{what}; not ported yet")
    if method == "scbf" and cfg.dp_noise_multiplier > 0:
        # an unknown accountant, or a classic bound outside its eps <= 1
        # domain, fails before training, not after it
        privacy.epsilon_for(cfg.dp_noise_multiplier, cfg.dp_delta, loops=1,
                            accountant=cfg.dp_accountant)
        if cfg.dp_amplification:
            if cfg.dp_accountant != "rdp":
                raise ValueError(
                    "dp_amplification is an RDP analysis; it composes on "
                    "the subsampled RDP curve, so dp_accountant="
                    f"{cfg.dp_accountant!r} cannot back the reported ε — "
                    "use 'rdp'")


def run_federated(cohort: MedicalCohort,
                  train_cfg: TrainConfig,
                  method: str = "scbf",
                  mlp_features: Optional[Tuple[int, ...]] = None,
                  verbose: bool = False,
                  device=None,
                  init_params: Optional[Sequence[dict]] = None,
                  perms: Optional[PermFn] = None,
                  dp_noise: Optional[NoiseFn] = None,
                  engine: Optional[str] = None) -> RunResult:
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
    "sequential").

    ``LoopRecord.wall_time`` spans the round — plan, local training,
    selection, encoding (the host then holds the payloads), the server
    update and the prune step, synchronised with the device — and leaves
    evaluation out; a fused run records each round of a chunk as the
    chunk's wall over its rounds (``wall_is_amortized``).
    """
    check_slice(train_cfg, method)
    dev = resolve_device(device)
    # the reference computes in full fp32: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, fed = train_cfg.scbf, train_cfg.fed
    gen = torch.Generator().manual_seed(train_cfg.seed)

    feats = mlp_features or (cohort.num_features, 256, 64, 1)
    params = from_numpy(init_params, dev) if init_params is not None \
        else init_mlp(feats, gen, dev)
    clients = _partition(cohort, train_cfg)
    eng = make_engine(engine or fed.engine, clients,
                      train_cfg.local_batch_size,
                      train_cfg.local_epochs, dev, bucket=fed.bucket,
                      pods=fed.pods)
    scheduler = SyncScheduler(cfg.num_clients, fed, train_cfg.seed)
    strategy = make_strategy(method)
    state = strategy.init(params)
    lrs = _lr_table(train_cfg)
    x_test = torch.as_tensor(cohort.x_test).to(dev)
    y_test = torch.as_tensor(cohort.y_test).to(dev)
    pruner = None
    if cfg.prune:
        pruner = pruning.Pruner(params, cohort.x_val,
                                prune_rate=cfg.prune_rate,
                                prune_total=cfg.prune_total,
                                impl=cfg.prune_impl,
                                compact=cfg.prune_compact)
    dp_on = method == "scbf" and cfg.dp_noise_multiplier > 0
    amplify = dp_on and cfg.dp_amplification
    # q from the scheduler's own cohort size, so the reported
    # amplification matches the sampling performed
    amp_q = min(1.0, scheduler.max_participants / cfg.num_clients)
    if amplify:
        privacy.amplified_epsilon_for(cfg.dp_noise_multiplier, amp_q,
                                      cfg.dp_delta, rounds=1)  # fail fast
    # ε composes per release: the spend is tracked per client and the
    # worst (most-releasing) client reported
    dp_releases = np.zeros(cfg.num_clients, dtype=np.int64)
    dp_gen = None
    if dp_on and dp_noise is None:
        dp_gen = torch.Generator(device=dev)
        dp_gen.manual_seed(int(torch.randint(2 ** 62, (1,), generator=gen)))
    result = RunResult(method=method + ("wp" if cfg.prune else ""),
                       dp_delta=cfg.dp_delta if dp_on else None)

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

    def _record(loop: int, P: int, emitted, up_params, params_now,
                wall: float, do_eval: bool, amortized: bool = False):
        """Append loop ``loop``'s record (and print it when verbose): its
        P participants' uploads (scbf: ``emitted``, the (payloads,
        stats); fedavg: ``up_params`` whole from each), the model after
        the loop and the loop's wall."""
        if method == "scbf":
            payloads, stats = emitted
            up_frac = float(np.mean([st.upload_fraction for st in stats])) \
                if stats else 0.0
            sparse_bytes = int(sum(p.nbytes for p in payloads))
            dense_bytes = int(sum(p.dense_nbytes for p in payloads))
        else:
            up_frac = 1.0 if P else 0.0
            dense_bytes = num_params(up_params) * 4 * P
            sparse_bytes = dense_bytes
        roc, pr, evaluated = _metrics(
            params_now, do_eval, pruner.masks if pruner is not None else None)
        if pruner is not None:
            # the effective model, whether neurons are masked or gone
            n_params = pruner.effective_param_count(params_now)
            hidden = pruner.hidden_sizes()
        else:
            n_params = num_params(params_now)
            hidden = hidden_sizes(params_now)
        eps, eps_un = _epsilons(loop)
        result.records.append(LoopRecord(
            loop=loop, auc_roc=roc, auc_pr=pr, upload_fraction=up_frac,
            sparse_bytes=sparse_bytes, dense_bytes=dense_bytes,
            wall_time=wall,
            flops_proxy=float(n_params) * cohort.x_train.shape[0],
            hidden_sizes=hidden, num_participants=P, epsilon=eps,
            evaluated=evaluated, epsilon_unamplified=eps_un,
            wall_is_amortized=amortized))
        if verbose:
            print(f"[{result.method}] loop {loop:02d} "
                  f"auc_roc={roc:.4f} auc_pr={pr:.4f} "
                  f"upload={up_frac:.2%} hidden={hidden} clients={P} "
                  f"t={wall:.2f}s"
                  + ("" if evaluated else " (metrics carried)"))

    draws = _RunDraws(train_cfg, eng, gen, dp_gen, perms, dp_noise)
    use_fused = (int(fed.fuse_rounds) > 1 and eng.name == "batched"
                 and (not cfg.prune or cfg.prune_impl == "mask"))
    if use_fused:
        result.final_params = _run_fused(
            train_cfg, method, eng, scheduler, state, lrs, draws,
            dp_releases, _record, pruner)
        return result

    for loop in range(train_cfg.global_loops):
        t0 = time.perf_counter()
        lr = float(lrs[loop])
        plan = scheduler.plan(loop)
        part = plan.participants
        P = plan.num_participants
        round_perms = draws.round_perms(loop, part)
        payloads, stats = [], []
        if P:
            if method == "scbf":
                nmasks = pruner.masks if pruner is not None else None
                keep_eff = pruner.emission_keep if pruner is not None \
                    else None
                # the batched engine takes the round's sampled-quantile
                # draws as the fused loop does; the sequential engine
                # draws them a client at a time on the same generator
                sampled = {} if eng.name != "batched" or not \
                    _sampled(method, state.params) else dict(
                        sample_idx=draws.sample_idx(
                            state.params, P,
                            None if nmasks is None else pruner.keep))
                payloads, stats = eng.scbf_round(
                    state.params, part, lr, round_perms, cfg, generator=gen,
                    nmasks=nmasks, keep=keep_eff,
                    noise=draws.injected_noise(loop, state.params, P)
                    if dp_on else None,
                    dp_generator=dp_gen, **sampled)
                dp_releases[np.asarray(part)] += 1
                expand = None
                if keep_eff is not None:
                    expand = (lambda ps, _k=keep_eff, _ref=state.params:
                              pruning.expand_payloads(ps, _k, _ref))
                contrib = RoundContribution(
                    num_examples=eng.counts[np.asarray(part)],
                    payloads=payloads, expand=expand)
            else:
                client_params, counts = eng.fedavg_round(
                    state.params, part, lr, round_perms)
                contrib = RoundContribution(num_examples=counts,
                                            client_params=client_params)
            state = strategy.aggregate(state, contrib)
        params = up_params = state.params

        # ---- pruning (SCBFwP / FAwP), inside the loop's wall clock ----
        if pruner is not None and pruner.active:
            # reshape: returns the sliced params; mask: updates the
            # keep-masks and returns params unchanged
            params = pruner.step(params)
        if pruner is not None and pruner.should_compact:
            params = pruner.compact(params)   # mask mode, budget spent
        state = dataclasses.replace(state, params=params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        _record(loop, P, (payloads, stats), up_params, params, wall,
                _should_eval(loop, train_cfg.global_loops,
                             train_cfg.eval_every))
    result.final_params = params
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
        for its bucket of slots — among the kept neurons under
        mask-mode pruning (``keep``, host index sets of the hidden
        layers)."""
        sizes = [int(layer["w"].shape[-1]) for layer in params]
        weights = None
        if keep is not None:
            weights = [torch.ones(m) for m in sizes]
            for l, kept in enumerate(keep):
                weights[l] = torch.zeros(sizes[l])
                weights[l][torch.from_numpy(np.asarray(kept))] = 1.0
        out = np.zeros((self.eng.round_slots(p_count) if p_count else 0,
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


def _run_fused(train_cfg: TrainConfig, method: str, eng, scheduler, state,
               lrs: np.ndarray, draws: _RunDraws, dp_releases: np.ndarray,
               record, pruner=None):
    """The fused round loop: chunks of S sync rounds with no host sync
    inside (port of the reference's ``_run_fused``).

    Each chunk is planned (``scheduler.plan_horizon``), its randomness
    drawn in the per-round order (``_RunDraws``) and its lr values sliced
    from the table, and every host→device copy made, in
    ``eng.prepare_fused_plan``; then each round — train → delta → select
    → DP → validity zeroing → ``scbf_sum_step`` (or ``fedavg_step``) —
    replays the captured round on the device.  The uploads are encoded
    once a chunk, after it (``eng.emit_fused_payloads``), so the per-round
    byte accounting is the per-round path's.  Evaluation happens at chunk
    boundaries only; the other records carry the last-known AUC with
    ``evaluated=False``, and every record's wall is the chunk's over its
    rounds (``wall_is_amortized``).

    Mask-mode SCBFwP (``pruner``): the keep-masks are an input of the
    round; while pruning is still removing neurons the chunks are one
    round long (``fused_chunk_len``), so APoZ and the mask update at each
    chunk boundary land at the per-round cadence, and compaction follows
    the last step.  A run captures at most two rounds a shape: the
    masked full geometry and the compacted one.  ``record`` appends a
    loop's record (``run_federated``'s ``_record``); returns the final
    params.
    """
    cfg = train_cfg.scbf
    dev = eng.device
    S = int(train_cfg.fed.fuse_rounds)
    B = eng.fused_num_slots(scheduler.max_participants)
    total_loops = train_cfg.global_loops
    dp_on = method == "scbf" and cfg.dp_noise_multiplier > 0
    loop0 = 0
    while loop0 < total_loops:
        prune_active = pruner is not None and pruner.active
        chunk = fused_chunk_len(total_loops - loop0, S, prune_active)
        t0 = time.perf_counter()
        plans = scheduler.plan_horizon(loop0, chunk)
        params = state.params
        nmasks = pruner.masks if pruner is not None else None
        sampled = _sampled(method, params)
        parts, rperms, wts, noise, samples = [], [], [], [], []
        for r, plan in enumerate(plans):
            part, P = plan.participants, plan.num_participants
            parts.append(part)
            rperms.append(draws.round_perms(loop0 + r, part) if P else [])
            if sampled:
                samples.append(draws.sample_idx(
                    params, P, None if nmasks is None else pruner.keep))
            if dp_on:
                noise.append(draws.noise(loop0 + r, params, P))
            if method == "fedavg":
                n = eng.counts[np.asarray(part)].astype(np.float64)
                wts.append((n / n.sum()).astype(np.float32) if P
                           else np.zeros(0, np.float32))
        fplan = eng.prepare_fused_plan(
            parts, lrs[loop0:loop0 + chunk], rperms, horizon=chunk,
            num_slots=B, weights=wts if method == "fedavg" else None,
            noise=noise if dp_on else None,
            sample_idx=samples if sampled else None)
        new_params, emitted = eng.run_fused_chunk(
            method, params, fplan, cfg, nmasks=nmasks,
            keep=pruner.emission_keep if pruner is not None else None)
        applied = sum(1 for plan in plans if plan.num_participants)
        state = dataclasses.replace(state, params=new_params,
                                    version=state.version + applied)
        if prune_active:
            # a one-round chunk: APoZ on the device, the mask update on
            # the host, at the per-round cadence
            pruner.step(state.params)
            if pruner.should_compact:
                state = dataclasses.replace(
                    state, params=pruner.compact(state.params))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_each = (time.perf_counter() - t0) / chunk

        for r, plan in enumerate(plans):
            loop = loop0 + r
            P = plan.num_participants
            if method == "scbf" and P:
                dp_releases[np.asarray(plan.participants)] += 1
            record(loop, P, emitted[r], state.params, state.params,
                   wall_each, r == chunk - 1 and _should_eval(
                       loop, total_loops, train_cfg.eval_every),
                   amortized=True)
        loop0 += chunk
    return state.params
