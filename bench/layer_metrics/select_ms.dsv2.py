"""select_ms.dsv2: device ms a traced step busy under the program's span
``select``: the selection, K1 on the leaf tables, the quantile and K2 in
place (core/channels.apply_factored_mask_slots).  Read from the span's
device-side extents (``harness/device_spans``); nothing when the window
holds none."""
from harness.device_spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "select")
