"""Learning-rate schedules as step -> lr callables (port of
``repro.optim.schedules``), evaluated in fp32 like the reference."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full(torch.as_tensor(step).shape, lr,
                                   dtype=torch.float32)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def fn(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        t = torch.clamp(s, max=float(decay_steps)) / decay_steps
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)
    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                         alpha: float = 0.0):
    """Linear warm-up to ``lr`` over ``warmup_steps``, then
    ``cosine_decay`` over the remaining ``decay_steps - warmup_steps``
    (both at least 1, as the reference guards them)."""
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), alpha)

    def fn(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm,
                           cos(torch.as_tensor(step) - warmup_steps))
    return fn
