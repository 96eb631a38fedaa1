"""GOOD: mask-mode compacted geometry — the reveal set is only ever
NARROWED after noising (validity zeroing, logical_and, kept-row
indexing), which reveals strictly less than the noise was calibrated
for.  Zero findings."""
import torch

from repro_torch.comm import wire
from repro_torch.core import privacy
from repro_torch.core.selection import select_gradients


def emit_compacted(delta, keep, valid, rate, sigma, clip, gen, num,
                   dp_releases=0):
    masked, masks, _, ops = select_gradients(delta, rate, "magnitude",
                                             generator=gen)
    z = privacy.draw_normals(masked, gen)
    noised = privacy.gaussian_mechanism(tuple(masked), z, sigma, clip,
                                        masks=masks)
    # narrowing is allowed: zero invalid slots, intersect with the
    # validity mask, then index down to the kept (compacted) rows
    noised = [torch.where(valid, g, 0.0) for g in noised]
    masks = [torch.logical_and(m, valid) for m in masks]
    kept = [g[k] for g, k in zip(noised, keep)]
    kept_masks = [m[k] for m, k in zip(masks, keep)]
    dp_releases += 1
    eps = privacy.epsilon_for(sigma, 1e-5, loops=dp_releases)
    return wire.encode_round(tuple(kept), ops, num), kept_masks, eps
