"""GOOD: every sanctioned padding-discipline idiom the port uses —
validity-masked sums with guarded Σvalid denominators, slicing back to
the live prefix, explicit mask casts, reductions that name their slot
axis (``dim=``), and weights that are exact zeros at dead slots.  Zero
findings."""
import torch


def _train_slots(x, b):
    """Producer stub with the 8-slot-chunk trainer's name and contract."""
    return x


def masked_mean(losses, valid, b):
    padded = _train_slots(losses, b)
    # the canonical fused-path accounting: masked sum over Σvalid,
    # with a positive guard for the all-masked round
    loss_sum = torch.sum(torch.where(valid, padded, 0.0))
    n = torch.clamp_min(torch.sum(valid.to(torch.float32)), 1.0)
    return loss_sum / n


def sliced_sum(losses, b, p_count):
    padded = _train_slots(losses, b)
    # the sequential-path idiom: slice back to the live prefix
    return torch.sum(padded[:p_count])


def per_slot_norms(grads, b):
    padded = _train_slots(grads, b)
    # a reduction inside each slot, over a named axis, keeps the slots
    return torch.sum(padded * padded, dim=1)


def cast_tally(valid):
    # explicit casts before arithmetic on a boolean mask
    return torch.sum(valid.to(torch.int32)) + valid.int().sum()


def masked_weighting(per, weights):
    # float weights are exact zeros at dead slots: multiplication
    # clears the padding, the guard clears the zero denominator
    num = torch.sum(per * weights)
    den = torch.sum(weights).clamp_min(1.0)
    return num / den
