"""Architecture registry (port of ``repro.configs``: copies of its data).

Every assigned architecture lives in its own module defining ``CONFIG``;
this package collects them into ``ARCHS`` and provides ``smoke_variant``
(the reduced config the per-arch smoke tests run on CPU: 2 layers,
d_model <= 512, <= 4 experts; a config with router groups keeps 8
experts in 4 groups, 2 of them kept, and holds half of them where it
holds a share).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.config import ArchConfig

from repro_torch.configs import (
    mlp_medical,
    deepseek_v2_236b,
    deepseek_v2_published,
    qwen2_5_32b,
    qwen1_5_0_5b,
    jamba_1_5_large_398b,
    whisper_medium,
    llama4_maverick_400b_a17b,
    qwen2_0_5b,
    mamba2_2_7b,
    chatglm3_6b,
    llama_3_2_vision_11b,
)

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        mlp_medical,
        deepseek_v2_236b,
        deepseek_v2_published,
        qwen2_5_32b,
        qwen1_5_0_5b,
        jamba_1_5_large_398b,
        whisper_medium,
        llama4_maverick_400b_a17b,
        qwen2_0_5b,
        mamba2_2_7b,
        chatglm3_6b,
        llama_3_2_vision_11b,
    )
}

# The ten pool-assigned architectures (paper's own MLP excluded); the
# port-only ``deepseek-v2-published`` is in ``ARCHS`` alone.
ASSIGNED = [
    "deepseek-v2-236b",
    "qwen2.5-32b",
    "qwen1.5-0.5b",
    "jamba-1.5-large-398b",
    "whisper-medium",
    "llama4-maverick-400b-a17b",
    "qwen2-0.5b",
    "mamba2-2.7b",
    "chatglm3-6b",
    "llama-3.2-vision-11b",
]


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests."""
    if cfg.family == "mlp":
        return dataclasses.replace(cfg, mlp_features=(64, 32, 8, 1))
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    num_heads = max(2, min(4, cfg.num_heads))
    num_kv = max(1, min(num_heads, cfg.num_kv_heads)) if cfg.num_kv_heads else 0
    # keep GQA ratio-ish: kv <= heads and divides heads
    while num_kv and num_heads % num_kv:
        num_kv -= 1
    kw = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
    if cfg.num_experts:
        kw.update(
            num_experts=4,
            experts_per_token=min(2, cfg.experts_per_token),
            num_shared_experts=min(1, cfg.num_shared_experts),
            moe_every=1 if cfg.moe_every == 1 else 2,
            first_dense_layers=min(cfg.first_dense_layers, 1),
        )
    if cfg.router_expert_groups > 1:
        kw.update(num_experts=8, router_expert_groups=4,
                  router_topk_groups=2)
    if cfg.experts_held:
        kw.update(experts_held=kw.get("num_experts", cfg.num_experts) // 2,
                  experts_offset=0)
    if cfg.dense_d_ff:
        kw.update(dense_d_ff=min(cfg.dense_d_ff, 768))
    if cfg.use_mla:
        kw.update(kv_lora_rank=32, qk_rope_dim=16)
    if cfg.q_lora_rank:
        kw.update(q_lora_rank=48)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.attention_every > 1:
        kw.update(attention_every=2)
    if cfg.cross_attn_every:
        kw.update(cross_attn_every=2, num_patch_tokens=8)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.frontend == "vision":
        kw.update(num_patch_tokens=8)
    return dataclasses.replace(cfg, **kw)
