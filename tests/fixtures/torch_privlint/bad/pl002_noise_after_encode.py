"""BAD (PL002): DP noise applied AFTER the payload was encoded — the
un-noised coordinates have already left the privacy boundary."""
from repro_torch.comm import wire
from repro_torch.core import privacy
from repro_torch.core.selection import select_gradients


def ship(grads, gen, rate, sigma, clip):
    masked, masks, _, ops = select_gradients(grads, rate, "magnitude",
                                             generator=gen)
    payload = wire.encode_selected(tuple(masked), ops)
    z = privacy.draw_normals(masked, gen)
    noised = privacy.gaussian_mechanism(payload, z, sigma, clip)
    return noised
