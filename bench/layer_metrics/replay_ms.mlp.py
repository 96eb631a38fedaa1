"""replay_ms.mlp: host ms a loop in the ``replay`` span
(``fed/engine.BatchedEngine.run_fused_chunk``: each round's static-input
copies, graph launch and stores), clipped to the traced window."""
from harness import spans


def read(ctx):
    return spans.per_loop_ms(ctx, "replay")
