"""Adam / AdamW (port of ``repro.optim.adam``): fp32 moments, bias
correction, decoupled weight decay, on trees of tensors."""
from __future__ import annotations

import torch

from repro_torch.optim.sgd import Optimizer, _f32_zeros, _lr_fn, _step0
from repro_torch.params import tree_map


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(learning_rate)

    def init(params):
        return {"step": _step0(), "m": tree_map(_f32_zeros, params),
                "v": tree_map(_f32_zeros, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr = lr_fn(step)
        f32 = lambda g: g.to(torch.float32)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * f32(g),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(f32(g)),
                     state["v"], grads)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)

        def upd(m_, v_, p=None):
            # bc1, bc2: 0-d fp32 (CPU) tensors, which broadcast onto any
            # device without a copy
            u = -lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr * weight_decay * p.to(torch.float32)
            return u

        if params is None:
            updates = tree_map(upd, m, v)
        else:
            updates = tree_map(upd, m, v, params)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
