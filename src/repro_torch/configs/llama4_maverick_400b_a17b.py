"""Llama-4 Maverick 400B (17B active) — MoE top-1 + shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E family card]

Assigned spec: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 128e top-1, early fusion.  Early-fusion multimodality is stubbed: the
assigned input shapes are token-only; the config documents the fusion point
(vision patches would be inlined as tokens before the embedding sum).
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,                 # per-expert intermediate
    vocab_size=202048,
    num_experts=128,
    num_shared_experts=1,
    experts_per_token=1,
    moe_every=2,               # interleaved dense / MoE
    rope_theta=500_000.0,
)
