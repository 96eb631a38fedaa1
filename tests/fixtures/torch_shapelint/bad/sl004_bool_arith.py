"""BAD (SL004): a boolean validity mask used arithmetically without an
explicit cast — ``torch.sum(valid)`` and ``x * valid`` both rely on the
implicit, dtype-dependent bool→int promotion."""
import torch


def participant_tally(valid):
    return torch.sum(valid)             # SL004: bool sum, no cast


def masked_by_promotion(per_slot, valid):
    return per_slot * valid             # SL004: bool arithmetic
