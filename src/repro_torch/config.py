"""Configs for the port — an own copy of ``repro.config``'s architecture,
input-shape and SCBF/federation/training dataclasses, with the same field
names and defaults so a config reads the same in both packages — the
engine too: ``FedConfig.engine`` is ``"batched"``, the slot-stacked
cohort engine, as in the reference.

Fields whose feature is not ported yet are kept (so configs stay
interchangeable) and refused by ``repro_torch.core.scbf.run_federated``
with the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Tuple


# ---------------------------------------------------------------------------
# Architecture
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    """A single architecture, as assigned from the public pool.

    ``family`` is one of dense | moe | ssm | hybrid | audio | vlm | mlp.
    Fields default to "off" so dense configs stay short.
    """

    name: str
    family: str
    source: str                      # citation (arXiv / model card)

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention flavour ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # chatglm3: 0.5 (2d RoPE on half the dims)
    sliding_window: int = 0          # 0 = full attention
    attention_every: int = 1         # jamba: 8 -> 1 attention layer per 8
    cross_attn_every: int = 0        # llama-3.2-vision: 5

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    q_lora_rank: int = 0             # 0: one dense q projection
    mla_kv_norm: bool = False        # RMSNorm on the latent before kv_up

    # --- YaRN rope scaling (DeepSeek-V2's rope_scaling; factor <= 1: off) ---
    yarn_factor: float = 0.0
    yarn_original_len: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1               # apply MoE every k-th layer
    first_dense_layers: int = 0      # deepseek: first layer is dense
    dense_d_ff: int = 0              # the leading dense layers' width; 0 = d_ff
    moe_capacity_factor: float = 1.25
    # the router's expert groups (DeepSeek-V2's n_group / topk_group: a
    # token's experts come from its top ``router_topk_groups`` groups); not
    # ``ModelCtx.moe_groups``, which are groups of tokens
    router_expert_groups: int = 1
    router_topk_groups: int = 1
    router_norm_topk: bool = True    # gates renormalised to sum to 1
    router_scale: float = 1.0        # routed_scaling_factor
    # the experts held here, [experts_offset, experts_offset + experts_held)
    # of the router's num_experts (0: all of them; expert parallelism's
    # share of one device)
    experts_held: int = 0
    experts_offset: int = 0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- encoder / decoder ---
    encoder_layers: int = 0          # whisper: 24
    encoder_seq: int = 1500          # whisper frame count after conv stub

    # --- modality frontend stubs ---
    frontend: str = "none"           # none | audio | vision
    num_patch_tokens: int = 1024     # vision stub patch count

    # --- plain-MLP family (the paper's own model) ---
    mlp_features: Tuple[int, ...] = ()   # e.g. (2917, 256, 64, 1)

    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    activation: str = "silu"         # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def num_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def held_experts(self) -> int:
        """The experts this device holds (all of them unless a share is
        set)."""
        return self.experts_held or self.num_experts

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode_natively(self) -> bool:
        """Sub-quadratic decode without the sliding-window variant."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        if self.family == "mlp":
            n = 0
            for fin, fout in zip(self.mlp_features[:-1], self.mlp_features[1:]):
                n += fin * fout + fout
            return n
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                 # unembed
        for layer in range(L):
            n += self._layer_params(layer)
        if self.encoder_layers:
            for layer in range(self.encoder_layers):
                n += self._enc_layer_params()
        n += d                                        # final norm
        return n

    def _attn_params(self) -> int:
        d, H, KV, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        if self.use_mla:
            r, rd = self.kv_lora_rank, self.qk_rope_dim
            if self.q_lora_rank:                     # q_a, its norm, q_b
                ql = self.q_lora_rank
                n = d * ql + ql + ql * H * (hd + rd)
            else:
                n = d * H * (hd + rd)                # q proj (nope+rope)
            n += r if self.mla_kv_norm else 0        # latent norm
            n += d * (r + rd)                        # kv down (+ shared k_rope)
            n += r * H * (hd + hd)                   # kv up (k_nope + v)
            n += H * hd * d                          # out
            return n
        n = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.qkv_bias:
            n += H * hd + 2 * KV * hd
        return n

    def _mlp_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff               # gated (wi, wg, wo)

    def _is_moe_layer(self, layer: int) -> bool:
        if not self.num_experts:
            return False
        if layer < self.first_dense_layers:
            return False
        return (layer % self.moe_every) == (self.moe_every - 1) \
            if self.moe_every > 1 else True

    def _is_attn_layer(self, layer: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attention_every > 1:
            return (layer % self.attention_every) == (self.attention_every - 1)
        return True

    def _layer_params(self, layer: int) -> int:
        d = self.d_model
        n = 2 * d                                    # two norms
        if self._is_attn_layer(layer):
            n += self._attn_params()
        elif self.family in ("ssm", "hybrid"):
            di, s = self.d_inner, self.ssm_state
            nh = di // self.ssm_head_dim
            n += d * (2 * di + 2 * s + nh)           # in_proj (x,z,B,C,dt)
            n += self.ssm_conv_width * (di + 2 * s)  # conv
            n += nh * 2                              # A_log, D
            n += di * d                              # out_proj
        if self.cross_attn_every and (layer % self.cross_attn_every
                                      == self.cross_attn_every - 1):
            n += self._attn_params() + d
        if self._is_moe_layer(layer):
            n += self.held_experts * self._mlp_params(self.d_ff)
            n += self.num_shared_experts * self._mlp_params(self.d_ff)
            n += d * self.num_experts                # router
        elif layer < self.first_dense_layers and self.dense_d_ff:
            n += self._mlp_params(self.dense_d_ff)
        else:
            n += self._mlp_params(self.d_ff)
        return n

    def _enc_layer_params(self) -> int:
        return 2 * self.d_model + self._attn_params() + self._mlp_params(self.d_ff)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        n = self.param_count()
        for layer in range(L):
            if self._is_moe_layer(layer):
                inactive = self.held_experts - self.experts_per_token
                n -= inactive * self._mlp_params(self.d_ff)
        return n


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


# ---------------------------------------------------------------------------
# SCBF / training config
# ---------------------------------------------------------------------------

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
    # differential privacy on the upload path (core.privacy)
    dp_noise_multiplier: float = 0.0  # 0 = off; sigma = nm * dp_clip_norm
    dp_clip_norm: float = 1.0        # L2 clip bound S on the masked delta
    dp_delta: float = 1e-5           # delta of the reported (eps, delta)
    dp_accountant: str = "rdp"       # rdp | classic
    dp_amplification: bool = False


@dataclass(frozen=True)
class ClockConfig:
    """Simulated wall-clock model (``fed.clock.SimClock``): per-client
    lognormal latencies, diurnal availability and deadline cuts that drop
    or spill."""

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
    """Seeded fault injection (``fed.faults.FaultInjector``): crashes,
    network failures with retries, replays, bit flips, NaN and poisoned
    updates."""

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
    """Cross-device federation scenario knobs (``repro_torch.fed``).

    The batched engine runs a round of any number of participants: one
    ``channel_norm`` launch (its workspace grows to the round), and one
    ``select_mask`` launch and one ``select_compact`` count a group of up
    to ``MAX_SLOTS`` (leaf, slot) pairs — 1,365 slots of the 3-layer MLP.
    ``fuse_rounds`` > 1 runs chunks of that many rounds with the server
    sum on the device (``core.scbf``'s fused loop, batched engine)."""

    engine: str = "batched"          # batched | sequential
    fuse_rounds: int = 1             # > 1: the fused round loop
    bucket: str = "pow2"             # batched-engine padding: pow2 | exact
    pods: int = 1                    # ranks of the pod axis (launch.mesh)
    # --- per-round client sampling (sync mode) ---
    sample_fraction: float = 1.0     # fraction of clients invited per round
    dropout_rate: float = 0.0        # P(sampled client never reports back)
    straggler_rate: float = 0.0      # P(client is slow this round)
    drop_stragglers: bool = True     # sync: stragglers miss the deadline
    # --- round scheduling mode ---
    mode: str = "sync"               # sync | fedbuff
    buffer_size: int = 10
    concurrency: int = 20
    staleness_exponent: float = 0.5
    server_lr: float = 1.0
    # --- data partition across clients ---
    partition: str = "iid"           # iid (equal shards) | dirichlet
    dirichlet_alpha: float = 0.5     # label-skew concentration (lower=worse)
    # --- chaos hardening and admission (fed.faults, fed.strategy) ---
    clock: ClockConfig = field(default_factory=ClockConfig)
    faults: FaultConfig = field(default_factory=FaultConfig)
    max_update_norm: float = 0.0
    norm_action: str = "reject"
    min_valid_participants: int = 0
    round_retries: int = 2
    retry_backoff_s: float = 30.0


@dataclass(frozen=True)
class ObsConfig:
    """Flight-recorder knobs (``repro_torch.obs``): ``device_metrics``
    turns the on-device telemetry on without a recorder (a run under
    ``recording`` collects whatever it says).  Every span reaches a
    running ``torch.profiler`` on its own (``obs.trace.span``)."""

    device_metrics: bool = False


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
    debug_checks: bool = False       # host-side checks (obs.checks)
    scbf: ScbfConfig = field(default_factory=ScbfConfig)
    fed: FedConfig = field(default_factory=FedConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    """The production mesh's geometry, the reference's field for field
    (``sharding.mesh.make_production_mesh`` builds it over ranks)."""

    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class HardwareConfig:
    """One card's published figures (NVIDIA's data sheet, H100 SXM, dense
    rates without sparsity, at the full power limit): the bounds that
    ``chip_smoke.py`` and ``PERF.md`` state a kernel's time against, and
    ``launch.roofline``'s terms.  The links: NVLink 4 at 900 GB/s a GPU
    (both directions together; NVIDIA H100 Tensor Core GPU data sheet)
    within a node of ``gpus_per_node`` cards, and between nodes one
    ConnectX-7 NIC a GPU at 400 Gb/s (NVIDIA ConnectX-7 data sheet; the
    DGX H100 pairs one with each GPU).  The reference's table holds TPU
    v5e figures; none of them carries over."""

    name: str = "NVIDIA H100 80GB HBM3"
    power_limit_w: float = 700.0
    hbm_bw: float = 3.35e12          # bytes/s
    hbm_bytes: float = 80e9
    peak_fp32: float = 67e12         # FLOP/s outside the tensor cores
    peak_bf16: float = 989e12        # FLOP/s on the tensor cores
    nvlink_bw: float = 900e9         # bytes/s a GPU, NVLink 4
    nic_bw: float = 400e9 / 8        # bytes/s a GPU, ConnectX-7 400 Gb/s
    gpus_per_node: int = 8


HARDWARE = HardwareConfig()


def replace(cfg, **kw):
    """dataclasses.replace that works through our frozen configs."""
    return dataclasses.replace(cfg, **kw)
