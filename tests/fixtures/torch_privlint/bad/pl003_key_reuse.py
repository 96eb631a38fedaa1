"""BAD (PL003): randomness hygiene violations on the noise path —
normals drawn once outside the client loop (every client gets the same
noise) and one draw consumed by two releases."""
import torch

from repro_torch.comm import wire
from repro_torch.core import privacy
from repro_torch.core.selection import select_gradients


def run_rounds(grads_by_client, rate, sigma, clip, seed,
               dp_releases=0):
    gen = torch.Generator().manual_seed(seed)
    z = privacy.draw_normals(grads_by_client[0], gen)
    out = []
    for g in grads_by_client:
        masked, masks, _, ops = select_gradients(g, rate, "magnitude",
                                                 generator=gen)
        # `z` is never redrawn inside the loop
        noised = privacy.gaussian_mechanism(tuple(masked), z, sigma,
                                            clip, masks=masks)
        dp_releases += 1
        out.append(wire.encode_selected(tuple(noised), ops))
    eps = privacy.epsilon_for(sigma, 1e-5, loops=dp_releases)
    return out, eps


def double_release(masked_a, masked_b, sigma, clip, z):
    na = privacy.gaussian_mechanism(tuple(masked_a), z, sigma, clip)
    nb = privacy.gaussian_mechanism(tuple(masked_b), z, sigma, clip)
    return na, nb
