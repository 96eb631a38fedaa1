"""Device selection for the port's entry points.

The rule: ``None`` means ``"cuda"``.  A run never moves to the CPU on its
own — without a CUDA device the caller must ask for ``"cpu"`` explicitly,
as the CPU parity tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device a run uses: ``None`` → cuda; cuda without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU (the port never falls back on its own)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; cuda or cpu")
    return dev
