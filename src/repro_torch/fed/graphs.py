"""A round of the fused loop as one captured CUDA graph.

``RoundProgram`` wraps a round body ``fn(*inputs) -> outputs`` (pytrees of
tensors on a CUDA device; other leaves must compare equal).  It is
captured once as a ``torch.cuda.CUDAGraph`` and then replayed a round at
a time: the round's inputs are copied into the graph's static input
buffers (device to device, on the stream), the graph is replayed, and the
static outputs hold the round's results until the next replay.  Nothing
in a replay waits on the host.  (On the CPU the engine calls the body.)

Capture follows PyTorch's whole-network recipe: the body runs a few times
on a side stream first (cuBLAS handles and workspaces, the autograd
engine's streams, and the channel-norm workspace are set up there), then
once under ``torch.cuda.graph``.  A failed capture raises; there is no
eager fallback on CUDA.  ``captures`` counts the graphs captured and
``replays`` the rounds replayed.

Kernel launches: a wrapper called under capture records its launch into
the graph, and its launch counter leaves it out.  The warm-up calls are
launches and count; a replay launches the graph's kernels without
calling a wrapper, so the counters do not see it — a profiler trace of
the replays does (each replay of a round launches K1 and K2 once).
The program keeps the channel-norm workspace its graph captured alive.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import channel_norm

WARMUP = 3                       # eager calls on a side stream before capture

captures = 0
replays = 0


def reset_captures() -> None:
    """Set ``captures`` and ``replays`` to 0."""
    global captures, replays
    captures = replays = 0


class RoundProgram:
    """One round body captured as a CUDA graph.  ``example`` gives the
    inputs' shapes, dtypes and device (the first round's inputs); every
    later call must match them."""

    def __init__(self, fn: Callable, *example):
        global captures
        self.fn = fn
        leaves, self._spec = pytree.tree_flatten(example)
        self.device = next(t.device for t in leaves
                           if isinstance(t, torch.Tensor))
        if self.device.type != "cuda":
            raise ValueError(f"a round program is captured on cuda, not "
                             f"{self.device}")
        self._static = [t.clone() if isinstance(t, torch.Tensor) else t
                        for t in leaves]
        static_args = pytree.tree_unflatten(self._static, self._spec)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn(*static_args)
        torch.cuda.current_stream(self.device).wait_stream(side)
        # the address the capture bakes in: a later, larger table moves
        # the wrapper to a new workspace, and this one must outlive the
        # graph
        self.workspace = channel_norm.workspace(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._out = self.fn(*static_args)
        self.graph = graph
        captures += 1

    def __call__(self, *inputs):
        """Replay the round on ``inputs``: the graph's static outputs,
        valid until the next call."""
        global replays
        leaves, spec = pytree.tree_flatten(inputs)
        if spec != self._spec:
            raise ValueError(f"round inputs changed structure: {spec} != "
                             f"{self._spec}")
        for dst, src in zip(self._static, leaves):
            if isinstance(dst, torch.Tensor):
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ValueError(
                        f"round input {tuple(src.shape)} {src.dtype} does "
                        f"not match the captured {tuple(dst.shape)} "
                        f"{dst.dtype}")
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
            elif dst != src:
                raise ValueError(f"round input {src!r} != captured {dst!r}")
        self.graph.replay()
        replays += 1
        return self._out


def program_key(*parts) -> Tuple:
    """A hashable key of what a captured round depends on: tensors by
    shape and dtype (None stays None), everything else as given."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return ("t", tuple(x.shape), str(x.dtype))
        return x
    leaves, spec = pytree.tree_flatten(parts)
    return (str(spec),) + tuple(one(x) for x in leaves)

