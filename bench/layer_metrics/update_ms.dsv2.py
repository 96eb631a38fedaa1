"""update_ms.dsv2: device ms a traced step busy under the program's span
``sum_update``: the clients' sum and the SGD update
(core/distributed._sum_and_update).  Read from the span's device-side
extents (``harness/device_spans``); nothing when the window holds none."""
from harness.device_spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "sum_update")
