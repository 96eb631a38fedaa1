"""GOOD: the full sanctioned chain — slot-stacked training → selection
→ normals drawn per round on the run's generator → release-ledger
accounting → one round encode.  Zero findings."""
from repro_torch.comm import wire
from repro_torch.core import privacy
from repro_torch.core.client import client_delta, local_train_slots
from repro_torch.core.selection import select_gradients


def federated_rounds(params, x, y, lr, perms_by_round, gen, rate, sigma,
                     clip, num, dp_releases=0):
    payloads = []
    for perms in perms_by_round:
        new_p = local_train_slots(tuple(params), x, y, lr, perms)
        delta = client_delta(tuple(params), new_p)
        masked, masks, _, ops = select_gradients(delta, rate, "magnitude",
                                                 generator=gen)
        z = privacy.draw_normals(masked, gen)
        noised = privacy.gaussian_mechanism(tuple(masked), z, sigma,
                                            clip, masks=masks, slots=True)
        dp_releases += 1
        payloads.append(wire.encode_round(tuple(noised), ops, num))
    eps = privacy.epsilon_for(sigma, 1e-5, loops=dp_releases)
    return payloads, eps
