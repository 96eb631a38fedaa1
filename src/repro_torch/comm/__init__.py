"""Sparse channel-exchange subsystem: wire formats + byte accounting (port
of ``repro.comm``; see ``repro_torch.comm.wire``).

The reference's exports, resolved on first use (``lazy_exports``).
"""
from repro_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    name: ("repro_torch.comm.wire", name) for name in (
        "LayerPayload", "Payload", "apply_payloads", "bitmap_bytes",
        "cheapest_bytes", "codec_breakdown", "codec_bytes", "coo_bytes",
        "decode", "dense_bytes", "encode", "encode_leaf",
        "tree_dense_bytes")})
