"""Helper module for the interprocedural fixture: ``total`` is CLEAN
in isolation (summing an arbitrary tensor is fine) — it only becomes an
SL001 once a caller in another module feeds it a padded slot stack."""
import torch


def total(xs):
    return torch.sum(xs)
