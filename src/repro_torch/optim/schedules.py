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
