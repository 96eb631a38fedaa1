"""GOOD: host loops that keep results on the device and cross to the
host once, after the loop; a comprehension gather; a loop over host
numbers.  Zero findings."""
import torch


def _round(p, b):
    return p + b.mean()


train_round = torch.cuda.make_graphed_callables(
    _round, (torch.ones(4), torch.ones(4)))


def run_rounds(params, batches):
    outs = []
    for b in batches:
        params = train_round(params, b)
        outs.append(params)
    torch.cuda.synchronize()
    return params, torch.stack(outs).cpu()


def gather(params, batches):
    return [train_round(params, b).cpu() for b in batches]


def schedule(lrs):
    total = 0.0
    for lr in lrs:
        total += float(lr)
    return total
