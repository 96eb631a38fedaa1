"""update_ms.lm: ms a step outside the gradient and selection phases:
the clients' sum and the SGD update (and the step's own dispatch): the
synchronised step wall less ``grad_ms.lm`` and ``select_ms.lm``."""


def read(ctx):
    return ctx["step_ms"] - ctx["grad_ms"] - ctx["select_ms"]
