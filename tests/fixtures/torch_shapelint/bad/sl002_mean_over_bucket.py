"""BAD (SL002): the "mean over B instead of Σvalid" bug, in both of its
shapes, against the admit-mask layout — the numerator is correctly
validity-masked, but the denominator counts every bucket slot
including the dead ones."""
import torch

from repro_torch.fed.cohort import bucket_size


def mean_over_bucket(losses, admit):
    masked = torch.where(admit, losses, 0.0)
    return torch.mean(masked)           # SL002: divides by B, not Σadmit


def sum_over_capacity(losses, admit, p_count, num_clients):
    b = bucket_size(p_count, num_clients)
    masked_sum = torch.sum(torch.where(admit, losses, 0.0))
    return masked_sum / b               # SL002: b counts dead slots
