"""Llama-3.2-Vision-11B — decoder with cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

Assigned spec: 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256,
cross-attention to vision embeddings every 5th layer.  The ViT vision
encoder + projector are a STUB: ``input_specs`` provides projected patch
embeddings of shape (batch, num_patch_tokens, d_model).
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    frontend="vision",
    num_patch_tokens=1024,
    rope_theta=500_000.0,
)
