"""plan_ms.mlp: host ms a loop in the fused loop's ``plan`` span (a
chunk's planning, its draws and its host-to-device copies,
``core/scbf._run_fused``), clipped to the traced window.  The window
opens after the second chunk's plan, so it holds 13 of the experiment's
14 traced chunks' plans."""
from harness import spans


def read(ctx):
    return spans.per_loop_ms(ctx, "plan")
