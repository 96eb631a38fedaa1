"""route_ms.dsv2: device ms a traced step busy under the program's span
``moe.route``: the MoE router: its product and softmax, the group limit,
top-k and the dispatch tables, forward and recompute
(models/moe.moe_apply).  Read from the span's device-side extents
(``harness/device_spans``); nothing when the window holds none."""
from harness.device_spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "moe.route")
