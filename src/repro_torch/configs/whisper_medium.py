"""Whisper-medium — encoder-decoder audio model. [arXiv:2212.04356]

Assigned spec: 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
The mel-spectrogram + conv frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings of shape (batch, 1500, d_model); we implement
the transformer encoder (24L) + decoder (24L) that consume them.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=24,             # decoder layers
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    cross_attn_every=1,        # every decoder layer cross-attends
    frontend="audio",
    norm="layernorm",
    activation="gelu",
    rope_theta=0.0,            # whisper uses learned/sinusoidal pos — we use rope_theta=0 -> none (learned abs)
)
