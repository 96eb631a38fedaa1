"""Mamba2-2.7B — attention-free SSM with SSD. [arXiv:2405.21060]

Assigned spec: 64L d_model=2560 (attn-free) vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads, chunked scan.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # attention-free, no separate FFN (SSD block)
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
)
