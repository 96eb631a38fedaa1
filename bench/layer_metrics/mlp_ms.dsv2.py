"""mlp_ms.dsv2: device ms a traced step busy under the program's span
``mlp``: the dense layer's MLP and the MoE layers' shared experts,
forward and recompute (models/layers.mlp_apply).  Read from the span's
device-side extents (``harness/device_spans``); nothing when the window
holds none."""
from harness.device_spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "mlp")
