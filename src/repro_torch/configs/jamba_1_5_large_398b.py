"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7, MoE. [arXiv:2403.19887]

Assigned spec: 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536,
MoE 16e top-2, attention every 8th layer, MoE every other layer.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attention_every=8,         # 1 attention : 7 mamba
    num_experts=16,
    experts_per_token=2,
    moe_every=2,               # MoE on every other layer
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
)
