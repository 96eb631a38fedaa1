"""Qwen1.5-0.5B — dense, QKV bias, MHA (kv == heads). [hf:Qwen/Qwen1.5-0.5B]

Assigned spec: 24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
)
