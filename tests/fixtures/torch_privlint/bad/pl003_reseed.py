"""BAD (PL003, torch only): the generator is re-seeded inside the client
loop with a seed the loop does not change, so every client's normals
are the same draw."""
import torch

from repro_torch.comm import wire
from repro_torch.core import privacy
from repro_torch.core.selection import select_gradients


def run_clients(grads_by_client, rate, sigma, clip, seed, dp_releases=0):
    gen = torch.Generator()
    out = []
    for g in grads_by_client:
        gen.manual_seed(seed)
        masked, masks, _, ops = select_gradients(g, rate, "magnitude")
        z = privacy.draw_normals(masked, gen)
        noised = privacy.gaussian_mechanism(tuple(masked), z, sigma, clip,
                                            masks=masks)
        dp_releases += 1
        out.append(wire.encode_selected(tuple(noised), ops))
    eps = privacy.epsilon_for(sigma, 1e-5, loops=dp_releases)
    return out, eps
