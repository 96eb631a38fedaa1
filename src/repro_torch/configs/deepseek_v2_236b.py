"""DeepSeek-V2 236B — MoE with Multi-head Latent Attention. [arXiv:2405.04434]

Assigned spec: 60L d_model=5120 128H (GQA kv=128) d_ff=1536 vocab=102400,
MoE 160e top-6, MLA kv_lora=512, 2 shared + 160 routed experts.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=1536,                 # per-expert intermediate size
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    num_experts=160,
    num_shared_experts=2,
    experts_per_token=6,
    moe_every=1,
    first_dense_layers=1,      # DeepSeek-V2: first layer uses a dense FFN
    rope_theta=10000.0,
)
