"""Carrying MLP weights between numpy and torch.

Params are a tuple of per-layer ``{"w": (fan_in, fan_out), "b":
(fan_out,)}`` dicts — the reference's layout (``repro.models.mlp_net``),
so weights move across as numpy arrays and tests compare like with like.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def from_numpy(params_np: Sequence[dict], device) -> Tuple[dict, ...]:
    """Numpy (or array-like) layer dicts → fp32 torch tensors on ``device``."""
    return tuple({k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                  device=device)
                  for k, v in layer.items()} for layer in params_np)


def to_numpy(params: Sequence[dict]) -> Tuple[dict, ...]:
    """Torch layer dicts → numpy layer dicts (one host copy per leaf)."""
    return tuple({k: v.detach().cpu().numpy() for k, v in layer.items()}
                 for layer in params)


def num_params(params: Sequence[dict]) -> int:
    return sum(int(layer["w"].numel()) + int(layer["b"].numel())
               for layer in params)
