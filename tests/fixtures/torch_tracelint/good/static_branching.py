"""GOOD: branching in captured code on structure only — shapes, ``is
None``, lengths, keyword-only Python scalars, tensors' attributes and a
list of tensors iterated for their devices.  Zero findings."""
import torch


def clip_step(delta, mask=None, *, threshold: float = 1.0):
    if mask is not None:
        delta = torch.where(mask, delta, 0.0)
    if delta.shape[0] > 1 and threshold > 0.0:
        delta = delta * threshold
    return delta


def fold(leaves, out=None):
    if any(t.device != leaves[0].device for t in leaves):
        raise ValueError("one device a table")
    if out is not None and len(out) != len(leaves):
        raise ValueError("one out a leaf")
    return [t * 2 for t in leaves]


class Captured:
    def __init__(self, delta, leaves):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.a = clip_step(delta, threshold=0.5)
            self.b = fold(leaves)
