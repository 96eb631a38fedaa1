"""SCBF / FedAvg driver — the paper's Algorithm 1 (port of
``repro.core.scbf``, per-round path).

One global loop:
  1. the sync scheduler picks the reporting cohort;
  2. the sequential engine trains every participant and channel-selects
     its delta (``layer_scores`` → α-quantile → exact edge mask, the
     score-and-mask pass running through the Hopper kernels on CUDA);
  3. the strategy folds the uploads into the server:
     W <- W + Σ_k ΔW̃_k for SCBF, the example-weighted mean for FedAvg;
  4. AUC-ROC / AUC-PR on the test set, plus the upload bytes.

The run happens on ``device`` — ``None`` means CUDA, and without a CUDA
device the caller must ask for the CPU (``repro_torch.device``).  Matmuls
run in full fp32 (TF32 off), as the reference computes.

Randomness: one CPU ``torch.Generator`` seeded from ``TrainConfig.seed``
draws the initial weights and every epoch permutation.  Parity tests
inject the reference's draws instead: ``init_params`` (numpy) and
``perms`` (``(loop, client, epoch) -> index array``).

Pruning (SCBFwP), DP, the batched and fused engines, FedBuff, the
simulated clock, fault injection, the admission gate and the flight
recorder are not ported yet; configs that ask for them raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.core.client import epoch_perms
from repro_torch.data.medical import (MedicalCohort, dirichlet_split,
                                      federated_split)
from repro_torch.device import resolve_device
from repro_torch.fed.engine import SequentialEngine
from repro_torch.fed.scheduler import SyncScheduler
from repro_torch.fed.strategy import RoundContribution, make_strategy
from repro_torch.metrics.auc import auc_pr, auc_roc
from repro_torch.models.mlp_net import hidden_sizes, init_mlp, mlp_forward
from repro_torch.optim import schedules
from repro_torch.params import from_numpy, num_params

PermFn = Callable[[int, int, int], np.ndarray]


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


def _evaluate(params, x: torch.Tensor, y: torch.Tensor, batch: int = 8192
              ) -> Tuple[float, float]:
    """(AUC-ROC, AUC-PR) of the model on (x, y), both on the run's device;
    one host copy at the end."""
    with torch.no_grad():
        scores = torch.cat([mlp_forward(params, x[s:s + batch])
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
    """Refuse what the port does not run yet, naming its ROADMAP item."""
    cfg, fed = train_cfg.scbf, train_cfg.fed
    if method not in ("scbf", "fedavg"):
        raise ValueError(method)
    if cfg.dp_noise_multiplier < 0:
        raise ValueError(f"dp_noise_multiplier must be >= 0, got "
                         f"{cfg.dp_noise_multiplier}")
    todo = [
        (cfg.prune, "pruning (SCBFwP) is ROADMAP A8"),
        (cfg.dp_noise_multiplier > 0, "DP on the upload path is ROADMAP A5"),
        (fed.engine != "sequential",
         f"engine={fed.engine!r}: the batched engine is ROADMAP A9"),
        (int(fed.fuse_rounds) != 1, "fused rounds are ROADMAP A10"),
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


def run_federated(cohort: MedicalCohort,
                  train_cfg: TrainConfig,
                  method: str = "scbf",
                  mlp_features: Optional[Tuple[int, ...]] = None,
                  verbose: bool = False,
                  device=None,
                  init_params: Optional[Sequence[dict]] = None,
                  perms: Optional[PermFn] = None) -> RunResult:
    """Run one federated experiment: method "scbf" | "fedavg".

    ``device``: None → cuda (raises without one); "cpu" on request.
    ``init_params``: numpy layer dicts to start from (else He init on the
    run's generator).  ``perms(loop, client, epoch)``: the permutation of
    that client's shard for that epoch (else drawn on the generator).

    ``LoopRecord.wall_time`` spans the round — plan, local training,
    selection, encoding (the host then holds the payloads) and the server
    update, synchronised with the device — and leaves evaluation out.
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
    eng = SequentialEngine(clients, train_cfg.local_batch_size,
                           train_cfg.local_epochs, dev)
    scheduler = SyncScheduler(cfg.num_clients, fed, train_cfg.seed)
    strategy = make_strategy(method)
    state = strategy.init(params)
    lrs = _lr_table(train_cfg)
    x_test = torch.as_tensor(cohort.x_test).to(dev)
    y_test = torch.as_tensor(cohort.y_test).to(dev)
    result = RunResult(method=method)

    init_model = params
    known = {"roc": None, "pr": None}

    def _metrics(params_now, do_eval: bool):
        """(auc_roc, auc_pr, evaluated) — last-known when not evaluating
        (the initial model, scored lazily, before any evaluation)."""
        if do_eval:
            known["roc"], known["pr"] = _evaluate(params_now, x_test, y_test)
            return known["roc"], known["pr"], True
        if known["roc"] is None:
            known["roc"], known["pr"] = _evaluate(init_model, x_test, y_test)
        return known["roc"], known["pr"], False

    def _round_perms(loop: int, part) -> List[list]:
        if perms is not None:
            return [[perms(loop, int(k), e)
                     for e in range(train_cfg.local_epochs)] for k in part]
        return [epoch_perms(int(eng.counts[int(k)]), train_cfg.local_epochs,
                            gen) for k in part]

    for loop in range(train_cfg.global_loops):
        t0 = time.perf_counter()
        lr = float(lrs[loop])
        plan = scheduler.plan(loop)
        part = plan.participants
        P = plan.num_participants
        round_perms = _round_perms(loop, part)
        payloads, stats = [], []
        if P:
            if method == "scbf":
                payloads, stats = eng.scbf_round(state.params, part, lr,
                                                 round_perms, cfg,
                                                 generator=gen)
                contrib = RoundContribution(
                    num_examples=eng.counts[np.asarray(part)],
                    payloads=payloads)
            else:
                client_params, counts = eng.fedavg_round(
                    state.params, part, lr, round_perms)
                contrib = RoundContribution(num_examples=counts,
                                            client_params=client_params)
            state = strategy.aggregate(state, contrib)
        params = state.params
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

        n_params = num_params(params)
        if method == "scbf":
            up_frac = float(np.mean([s.upload_fraction for s in stats])) \
                if stats else 0.0
            sparse_bytes = int(sum(p.nbytes for p in payloads))
            dense_bytes = int(sum(p.dense_nbytes for p in payloads))
        else:
            up_frac = 1.0 if P else 0.0
            dense_bytes = n_params * 4 * P
            sparse_bytes = dense_bytes

        roc, pr, evaluated = _metrics(
            params, _should_eval(loop, train_cfg.global_loops,
                                 train_cfg.eval_every))
        rec = LoopRecord(
            loop=loop, auc_roc=roc, auc_pr=pr,
            upload_fraction=up_frac,
            sparse_bytes=sparse_bytes, dense_bytes=dense_bytes,
            wall_time=wall,
            flops_proxy=float(n_params) * cohort.x_train.shape[0],
            hidden_sizes=hidden_sizes(params),
            num_participants=P, evaluated=evaluated)
        result.records.append(rec)
        if verbose:
            print(f"[{result.method}] loop {loop:02d} "
                  f"auc_roc={roc:.4f} auc_pr={pr:.4f} "
                  f"upload={up_frac:.2%} hidden={rec.hidden_sizes} "
                  f"clients={P} t={wall:.2f}s")
    result.final_params = params
    return result
