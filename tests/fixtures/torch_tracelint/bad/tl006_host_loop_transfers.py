"""Per-iteration device→host crossings in host loops — the reason the
fused round loop exists.  tracelint must flag a synchronize, np.asarray
of a graphed call, and .cpu() of one inside the loop body (TL006)."""
import numpy as np
import torch


def _round(p, b):
    return p + b.mean()


train_round = torch.cuda.make_graphed_callables(
    _round, (torch.ones(4), torch.ones(4)))


def run_rounds(params, batches):
    history = []
    for b in batches:
        params = train_round(params, b)
        torch.cuda.synchronize()                        # sync per round
        history.append(np.asarray(train_round(params, b)))
        history.append(train_round(params, b).cpu())
    return params, history
