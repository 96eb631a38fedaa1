"""GOOD: every accepted way to build a CUDA graph or load a kernel
library once — at module level, in ``__init__`` (the object is the
cache), in an lru_cache factory, and into a cache-guarded dict slot.
Zero findings."""
import ctypes
import functools

import torch


def body(x):
    return torch.relu(x) * 2.0


class Program:
    def __init__(self, fn, x):
        self.fn = fn
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self.fn(x)

    def __call__(self):
        self.graph.replay()
        return self.out


@functools.lru_cache(maxsize=None)
def library(path: str):
    return ctypes.CDLL(path)


class Engine:
    def __init__(self):
        self._programs = {}

    def program(self, key, fn, x):
        if key not in self._programs:
            self._programs[key] = Program(fn, x)
        return self._programs[key]

    def run(self, xs):
        prog = self.program("relu", body, xs[0])
        return [prog() for _ in xs]
