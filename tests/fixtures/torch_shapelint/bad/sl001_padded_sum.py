"""BAD (SL001): the bucketed-padding shape in the port's idiom — a
round of ``p_count`` losses padded to a whole number of 8-slot chunks
(``slots.slot_chunked``), then reduced WITHOUT a validity mask.  The
padded slots hold filler, so the sum counts them."""
import torch

from repro_torch.slots import slot_chunked


def round_loss_sum(losses, w):
    padded = slot_chunked(torch.mul, losses, w)
    return torch.sum(padded)            # SL001: no mask, no slice
