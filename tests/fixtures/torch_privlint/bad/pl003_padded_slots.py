"""BAD (PL003): the padded-slot case, for torch generators — a fused
plan's per-slot normals are drawn on one seeded generator for the real
slots, and every padded slot is filled with slot 0's draw, so all
padding slots share one noise stream (the key-row padding bug the
reference's privlint first caught, ``pad_rows``)."""
import torch

from repro_torch.core import privacy


def pad_normals(rows, horizon, num_slots, shape):
    out = torch.zeros((horizon, num_slots) + shape)
    for r, z in enumerate(rows):
        if z.shape[0]:
            out[r, :z.shape[0]] = z
            out[r, z.shape[0]:] = z[0]
    return out


def plan_normals(real, seed, horizon, num_slots, shape):
    gen = torch.Generator().manual_seed(seed)
    rows = [privacy.draw_normals(real, gen) for _ in range(horizon)]
    return pad_normals(rows, horizon, num_slots, shape)
