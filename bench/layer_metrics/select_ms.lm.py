"""select_ms.lm: ms a step in ``core/channels.apply_factored_mask_slots``
(K1 on the leaf tables, the quantile, K2 in place), by CUDA events the
benchmark records around the module attribute."""


def read(ctx):
    return ctx["select_ms"]
