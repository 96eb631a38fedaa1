"""BAD (TL001): the per-call rebuild, for CUDA graphs — ``_evaluate``
captures a fresh ``torch.cuda.CUDAGraph`` of the forward pass on every
evaluation, so every call re-captures (and holds a new memory pool)
instead of replaying.  The fix keeps one graph a shape, built once."""
import torch


def mlp_forward(params, x):
    for layer in params:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x[:, 0]


def _evaluate(params, x):
    graph = torch.cuda.CUDAGraph()          # rebuilt (re-captured) per call
    with torch.cuda.graph(graph):
        out = mlp_forward(params, x)
    graph.replay()
    return out
