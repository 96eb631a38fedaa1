"""BAD (PL004): accounting skew — a noised payload emitted with no
accountant update anywhere on the call chain, and a ledger that spends
the budget twice for one emission."""
from repro_torch.comm import wire
from repro_torch.core import privacy
from repro_torch.core.selection import select_gradients


def emit_unaccounted(grads, rate, sigma, clip, gen):
    masked, masks, _, ops = select_gradients(grads, rate, "magnitude",
                                             generator=gen)
    z = privacy.draw_normals(masked, gen)
    noised = privacy.gaussian_mechanism(tuple(masked), z, sigma, clip,
                                        masks=masks)
    return wire.encode_selected(tuple(noised), ops)


def emit_double_counted(grads, rate, sigma, clip, gen, dp_releases):
    masked, masks, _, ops = select_gradients(grads, rate, "magnitude",
                                             generator=gen)
    z = privacy.draw_normals(masked, gen)
    noised = privacy.gaussian_mechanism(tuple(masked), z, sigma, clip,
                                        masks=masks)
    dp_releases += 1
    payload = wire.encode_selected(tuple(noised), ops)
    dp_releases += 1
    return payload
