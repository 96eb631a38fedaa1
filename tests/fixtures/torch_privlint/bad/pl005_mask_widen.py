"""BAD (PL005): the reveal mask is widened AFTER the Gaussian noise was
calibrated to it — the extra coordinates ship with zero noise budget.
Includes the mask-mode compacted-geometry variant (re-appending rows
with torch.cat)."""
import torch

from repro_torch.comm import wire
from repro_torch.core import privacy
from repro_torch.core.selection import select_gradients


def widen_after_noise(grads, extra_masks, rate, sigma, clip, gen,
                      dp_releases=0):
    masked, masks, _, ops = select_gradients(grads, rate, "magnitude",
                                             generator=gen)
    z = privacy.draw_normals(masked, gen)
    noised = privacy.gaussian_mechanism(tuple(masked), z, sigma,
                                        clip, masks=masks)
    masks = torch.logical_or(masks, extra_masks)
    dp_releases += 1
    return wire.encode_selected(tuple(noised), ops), masks


def widen_compacted_geometry(grads, keep_rows, rate, sigma, clip, gen,
                             dp_releases=0):
    masked, masks, _, ops = select_gradients(grads, rate, "magnitude",
                                             generator=gen)
    z = privacy.draw_normals(masked, gen)
    noised = privacy.gaussian_mechanism(tuple(masked), z, sigma,
                                        clip, masks=masks)
    # compacted keep-mask geometry grown back after noising
    masks = torch.cat([masks, keep_rows], axis=0)
    dp_releases += 1
    return wire.encode_selected(tuple(noised), ops), masks
