"""DeepSeek-V2 236B as published — every width and mechanism of its
``config.json`` (https://huggingface.co/deepseek-ai/DeepSeek-V2, arXiv:2405.04434).

Beside ``deepseek_v2_236b`` (the assigned spec, which the JAX package
shares) it adds the q-lora query (``q_lora_rank`` 1536: ``q_a_proj``,
RMSNorm, ``q_b_proj``), the RMSNorm on the 512-wide latent
(``kv_a_layernorm``), YaRN rope scaling (factor 40 over 4,096 positions,
β 32/1, ``mscale`` = ``mscale_all_dim`` = 0.707), the 12,288-wide leading
dense layer, and group-limited greedy routing (8 groups, the top 3 kept,
top-6 within them, gates not renormalised but scaled by 16).  Not in
``ASSIGNED``: the JAX package has no such config.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-published",
    family="moe",
    source="https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,              # qk_nope_head_dim = v_head_dim
    d_ff=1536,                 # moe_intermediate_size
    dense_d_ff=12288,          # intermediate_size (first_k_dense_replace)
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_dim=64,
    mla_kv_norm=True,
    yarn_factor=40.0,
    yarn_original_len=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    num_experts=160,
    num_shared_experts=2,
    experts_per_token=6,
    moe_every=1,
    first_dense_layers=1,
    router_expert_groups=8,
    router_topk_groups=3,
    router_norm_topk=False,
    router_scale=16.0,
    rope_theta=10000.0,
)
