"""The LM cells' weights, drawn on the device from the seed.

One normal draw in bf16 (the type the weights are served in) fills every
bf16 matrix at once, each leaf a view of it scaled by its fan-in; the
fp32 router takes a draw of its own; norm scales are ones.  The same seed
on the same device gives the same bits, so the reference draws them
again after the program's state is freed.  Nothing of the program: the
leaves come as (name, shape, dtype) from the caller."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], torch.dtype]


def fan_in_scale(name: str, shape: Sequence[int]) -> float:
    """1/sqrt(fan-in): the embedding's rows are d_model wide, every other
    matrix (stacked or not) reads its second-to-last axis."""
    if name.startswith("embed."):
        return 1.0 / math.sqrt(shape[-1])
    return 1.0 / math.sqrt(shape[-2])


def draw(leaves: Sequence[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} of ``leaves`` (in their given order) from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[torch.dtype, List[Leaf]] = {}
    for leaf in leaves:
        name, shape, dtype = leaf
        if name.endswith(".scale"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            groups.setdefault(dtype, []).append(leaf)
    for dtype in sorted(groups, key=str):
        group = groups[dtype]
        total = sum(math.prod(shape) for _, shape, _ in group)
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        at = 0
        for name, shape, _ in group:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(
                fan_in_scale(name, shape))
            at += n
        del flat
    return {name: out[name] for name, _, _ in leaves}
