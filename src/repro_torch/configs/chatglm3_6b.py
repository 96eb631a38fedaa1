"""ChatGLM3-6B — dense, 2d (half-dim) RoPE, GQA kv=2. [arXiv:2406.12793]

Assigned spec: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
ChatGLM applies rotary embedding to half of each head dim (rope_fraction=0.5).
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,
    qkv_bias=True,             # chatglm uses bias on QKV only
)
