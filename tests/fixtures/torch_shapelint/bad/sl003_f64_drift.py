"""BAD (SL003): float64 drift inside a captured round — an f64 scalar
minted with ``np.float64`` and a ``.double()`` cast both change the
compute dtype of the program the graph captured."""
import numpy as np
import torch


def drifting_step(params, grads):
    scale = np.float64(0.5)             # SL003: f64 creation in capture
    wide = grads.double()               # SL003: .double() is f64
    return params - scale * wide


def capture(params, grads):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = drifting_step(params, grads)
    return graph, out
