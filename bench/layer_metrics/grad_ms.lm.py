"""grad_ms.lm: ms a step in ``core/distributed.client_gradients`` (every
client's forward and backward through the model zoo, MLA and the MoE),
by CUDA events the benchmark records around the module attribute, read
after the step has synchronised."""


def read(ctx):
    return ctx["grad_ms"]
