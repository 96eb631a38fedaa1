"""Slot-stacked arithmetic in chunks of a fixed slot count.

The batched engine runs the S slots of a round (or a pod's share of
them) as ``(S, …)`` tensors.  On the card a batched GEMM's kernel, and a
reduction's split over thread blocks, are chosen from the call's shape,
the slot count included, so a slot's bits would depend on how many slots
share the call: a pod rank's B/P slots against one device's B.  Every
slot-stacked product and per-slot reduction therefore runs on chunks of
exactly ``SLOT_CHUNK`` slots, the last padded with zeros: each slot sees
the same call shapes whatever S is.  The paper's round of 5 clients is
one chunk with 3 padded slots.
"""
from __future__ import annotations

from typing import Callable

import torch

SLOT_CHUNK = 8


def slot_chunked(fn: Callable[..., torch.Tensor], *xs: torch.Tensor
                 ) -> torch.Tensor:
    """``fn`` over ``SLOT_CHUNK``-slot chunks of the ``(S, …)`` tensors
    ``xs`` (zero-padded to a multiple of the chunk), its results
    concatenated along the slot axis and cut back to S slots."""
    s = xs[0].shape[0]
    pad = -s % SLOT_CHUNK
    if pad:
        xs = tuple(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                   for x in xs)
    outs = [fn(*chunk) for chunk in zip(*(x.split(SLOT_CHUNK)
                                          for x in xs))]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out[:s] if pad else out
