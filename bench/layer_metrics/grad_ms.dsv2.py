"""grad_ms.dsv2: device ms a traced step busy under the program's span
``client_grad``: every client's forward and backward (remat's recompute
included) and its copy into the slot buffer
(core/distributed.client_gradients).  Read from the span's device-side
extents (``harness/device_spans``); nothing when the window holds none."""
from harness.device_spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "client_grad")
