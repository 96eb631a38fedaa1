"""BAD (SL006): dividing by (and taking the log of) Σvalid with no
positive guard — the all-slots-masked round (quorum miss, total fault
injection) makes the denominator 0 and poisons the aggregate with
inf/nan."""
import torch


def unguarded_mean(loss_sum, valid):
    n = torch.sum(valid.to(torch.float32))
    return loss_sum / n                 # SL006: n == 0 when all masked


def unguarded_log(valid):
    n = torch.sum(valid.float())
    return torch.log(n)                 # SL006: log(0) = -inf
