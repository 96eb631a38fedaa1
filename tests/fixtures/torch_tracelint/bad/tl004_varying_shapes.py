"""The re-capture class: a graphed callable fed a slice whose extent
changes per loop iteration.  A CUDA graph replays the shapes it
captured, so every distinct extent needs a new capture.  tracelint must
flag the call site (TL004) both for a direct slice argument and for a
local assigned from one."""
import torch


def _score(x):
    return torch.tanh(x).sum(dim=1)


score_batch = torch.cuda.make_graphed_callables(_score, (torch.ones(8, 4),))


def stream_scores(x, sizes):
    out = []
    start = 0
    for n in sizes:                        # n varies per iteration
        out.append(score_batch(x[start:start + n]))     # direct slice
        xb = x[start:start + n]
        out.append(score_batch(xb))                     # via a local
        start += n
    return out
