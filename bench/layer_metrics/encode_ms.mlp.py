"""encode_ms.mlp: host ms a loop of the emission's host encode: the
``encode`` span (``fed/engine.BatchedEngine.emit_fused_payloads``) less
the ``encode.wait`` spans inside it, clipped to the traced window."""
from harness import spans


def read(ctx):
    return spans.per_loop_ms(ctx, "encode", self_time=True)
