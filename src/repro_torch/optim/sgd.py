"""SGD (optionally with momentum) as an (init, update) pair (port of
``repro.optim.sgd``), on trees of tensors: tuples, lists and dicts of
``torch.Tensor`` (``None`` leaves pass through).

The optax convention, as in the reference:
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Moments and updates are fp32; the step counter is an int32 tensor.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.params import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, in each param's dtype."""
    return tree_map(lambda p, u: (p + u.to(p.dtype)) if u is not None
                    else p, params, updates)


def _lr_fn(learning_rate):
    return learning_rate if callable(learning_rate) \
        else (lambda _: learning_rate)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def sgd(learning_rate, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(learning_rate)

    def init(params):
        if momentum == 0.0:
            return {"step": _step0()}
        return {"step": _step0(), "mu": tree_map(_f32_zeros, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr = lr_fn(step)
        if momentum == 0.0:
            updates = tree_map(lambda g: -lr * g.to(torch.float32), grads)
            return updates, {"step": step}
        mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                      state["mu"], grads)
        updates = tree_map(lambda m: -lr * m, mu)
        return updates, {"step": step, "mu": mu}

    return Optimizer(init, update)
