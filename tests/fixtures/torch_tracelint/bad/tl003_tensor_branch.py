"""Python control flow on tensors inside captured code: the read fails
under capture, or one branch is baked into every replay.  tracelint
must flag both the ``if`` and the ``while`` (TL003)."""
import torch


def clamp_step(delta, threshold):
    if delta.sum() > threshold:             # branches on a tensor
        return delta * 0.5
    return delta


def iterate(x):
    while x.max() > 1.0:                    # tensor-valued loop condition
        x = x * 0.9
    return x


class Captured:
    def __init__(self, delta, threshold, x):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin()
        self.out = clamp_step(delta, threshold)
        self.y = iterate(x)
        self.graph.capture_end()
