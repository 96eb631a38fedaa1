"""experts_ms.dsv2: device ms a traced step busy under the program's span
``moe.experts``: the held experts' gather, products and combine, forward
and recompute (models/moe._experts).  Read from the span's device-side
extents (``harness/device_spans``); nothing when the window holds none."""
from harness.device_spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "moe.experts")
