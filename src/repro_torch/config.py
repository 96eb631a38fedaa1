"""Training configs for the port — an own copy of ``repro.config``'s
SCBF/federation/training dataclasses, with the same field names and
defaults so a config reads the same in both packages.

One default differs: ``FedConfig.engine`` is ``"sequential"``.  The
port has only the per-client loop so far (the batched cohort engine is
ROADMAP A9); at full participation with equal shards the reference's
two engines give identical trajectories, so this changes no result.

Fields whose feature is not ported yet are kept (so configs stay
interchangeable) and refused by ``repro_torch.core.scbf.run_federated``
with the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ScbfConfig:
    """The paper's hyper-parameters (§2.1, Algorithm 1)."""

    upload_rate: float = 0.10        # alpha — fraction of channels uploaded
    selection: str = "positive"      # positive | negative (paper §2.1)
    num_clients: int = 5             # paper §2.2
    # pruning (SCBFwP) — ROADMAP A8
    prune: bool = False
    prune_rate: float = 0.10         # theta — fraction pruned per loop
    prune_total: float = 0.47        # theta_total
    prune_impl: str = "reshape"      # reshape | mask
    prune_compact: bool = True
    # scale-out knobs (beyond paper)
    factored: bool = True            # factored channel scores for big models
    compressed_exchange: bool = False  # top-k gather exchange across pods
    score_norm: bool = False         # per-layer score normalisation
    # differential privacy on the upload path — ROADMAP A5
    dp_noise_multiplier: float = 0.0  # 0 = off; sigma = nm * dp_clip_norm
    dp_clip_norm: float = 1.0        # L2 clip bound S on the masked delta
    dp_delta: float = 1e-5           # delta of the reported (eps, delta)
    dp_accountant: str = "rdp"       # rdp | classic
    dp_amplification: bool = False


@dataclass(frozen=True)
class ClockConfig:
    """Simulated wall-clock model — ROADMAP A11 (not ported yet)."""

    enabled: bool = False
    compute_med_s: float = 10.0
    compute_sigma: float = 0.25
    hetero_sigma: float = 0.6
    net_med_s: float = 2.0
    net_sigma: float = 0.5
    deadline_quantile: float = 0.9
    deadline_action: str = "drop"    # drop | spill
    availability_mean: float = 1.0
    diurnal_amplitude: float = 0.0
    day_s: float = 86400.0
    round_gap_s: float = 0.0


@dataclass(frozen=True)
class FaultConfig:
    """Seeded fault injection — ROADMAP A11 (not ported yet)."""

    enabled: bool = False
    seed: int = 0
    crash_rate: float = 0.0
    net_fail_rate: float = 0.0
    net_retries: int = 3
    net_backoff_s: float = 1.0
    duplicate_rate: float = 0.0
    bitflip_rate: float = 0.0
    nan_rate: float = 0.0
    poison_rate: float = 0.0
    poison_scale: float = 16.0


@dataclass(frozen=True)
class FedConfig:
    """Cross-device federation scenario knobs (``repro_torch.fed``)."""

    engine: str = "sequential"       # sequential (batched: ROADMAP A9)
    fuse_rounds: int = 1             # > 1: ROADMAP A10
    bucket: str = "pow2"             # batched-engine padding (A9)
    pods: int = 1                    # pod sharding (A15)
    # --- per-round client sampling (sync mode) ---
    sample_fraction: float = 1.0     # fraction of clients invited per round
    dropout_rate: float = 0.0        # P(sampled client never reports back)
    straggler_rate: float = 0.0      # P(client is slow this round)
    drop_stragglers: bool = True     # sync: stragglers miss the deadline
    # --- round scheduling mode ---
    mode: str = "sync"               # sync (fedbuff: ROADMAP A11)
    buffer_size: int = 10
    concurrency: int = 20
    staleness_exponent: float = 0.5
    server_lr: float = 1.0
    # --- data partition across clients ---
    partition: str = "iid"           # iid (equal shards) | dirichlet
    dirichlet_alpha: float = 0.5     # label-skew concentration (lower=worse)
    # --- chaos hardening and admission (ROADMAP A11) ---
    clock: ClockConfig = field(default_factory=ClockConfig)
    faults: FaultConfig = field(default_factory=FaultConfig)
    max_update_norm: float = 0.0
    norm_action: str = "reject"
    min_valid_participants: int = 0
    round_retries: int = 2
    retry_backoff_s: float = 30.0


@dataclass(frozen=True)
class ObsConfig:
    """Flight-recorder knobs — ROADMAP A12 (not ported yet)."""

    device_metrics: bool = False
    annotate: bool = True


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"           # the federated driver runs plain SGD
    learning_rate: float = 1e-3
    lr_schedule: str = "constant"    # constant | cosine (per global loop)
    weight_decay: float = 0.0
    momentum: float = 0.0
    global_loops: int = 30
    # evaluate AUCROC/AUCPR every N loops (plus always the final loop);
    # non-evaluated loops carry the last-known metrics with
    # LoopRecord.evaluated = False
    eval_every: int = 1
    local_epochs: int = 1
    local_batch_size: int = 256
    seed: int = 0
    remat: bool = True
    debug_checks: bool = False       # ROADMAP A12
    scbf: ScbfConfig = field(default_factory=ScbfConfig)
    fed: FedConfig = field(default_factory=FedConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)


def replace(cfg, **kw):
    """dataclasses.replace that works through our frozen configs."""
    return dataclasses.replace(cfg, **kw)
