"""Param construction helpers (port of ``repro.models.common``).

Every init function builds TWO parallel trees with identical structure:
``params`` (the tensors) and ``axes`` (logical axis names per tensor
dimension, a comma-joined string leaf), in the reference's nested-dict
layout, so a port tree flattens to the reference's leaves in the same
order (``repro_torch.params.tree_paths``).  The axis names are the
reference's vocabulary (``layers``, ``vocab``, ``embed``, ``heads``,
``kv``, ``mlp``, ...), from which ``sharding.rules`` places params on a
``(data, model)`` mesh.

Randomness comes from one ``torch.Generator``, drawn leaf after leaf in
init order; the tensors land on the generator's device.  ``gen=None``
builds the tree on the ``meta`` device: shapes and dtypes only.  JAX's
threefry stream cannot be reproduced, so parity tests carry the
reference's initial params across (``params.from_numpy_tree``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.params import tree_leaves, tree_map, tree_unflatten

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Φ(-2) and Φ(2): the standard normal's mass below the truncation points
_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def ax(*names: str) -> str:
    """Logical axis names joined into an axes leaf (``ax("embed", "mlp")``
    is ``"embed,mlp"``)."""
    return ",".join(names)


def split_ax(axes: str):
    return tuple(axes.split(",")) if axes else ()


def device_of(gen: Optional[torch.Generator]) -> torch.device:
    """Where an init drawn from ``gen`` puts its tensors."""
    return torch.device("meta") if gen is None else gen.device


# entries a leaf draws at once: a larger leaf (an MoE expert stack) is
# drawn in pieces of this many, so its fp32 temporaries stay ~1 GB each
DRAW_CHUNK = 1 << 28


def _trunc_normal_draw(gen: torch.Generator, shape, scale: float,
                       dtype: torch.dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    p = _PHI_LO + (_PHI_HI - _PHI_LO) * u
    x = torch.erfinv(2.0 * p - 1.0) * math.sqrt(2.0)
    return (torch.clamp(x, -2.0, 2.0) * scale).to(dtype)


def trunc_normal(gen: Optional[torch.Generator], shape, scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """Normal on [-2, 2], times ``scale``, drawn in fp32 by the inverse CDF
    (as ``torch.nn.init.trunc_normal_`` draws it), cast to ``dtype``; a
    leaf of more than ``DRAW_CHUNK`` entries is drawn that many at a time,
    in flat order."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    n = math.prod(shape)
    if n <= DRAW_CHUNK:
        return _trunc_normal_draw(gen, shape, scale, dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(-1)
    for a in range(0, n, DRAW_CHUNK):
        b = min(n, a + DRAW_CHUNK)
        flat[a:b] = _trunc_normal_draw(gen, (b - a,), scale, dtype)
    return out


def dense_init(gen, fin: int, fout: int, axes: str, dtype,
               bias: bool = False, scale: Optional[float] = None):
    """(params, axes) for a dense layer.  fan-in scaled init.

    ``axes`` e.g. "embed,mlp".
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(fin)
    p = {"w": trunc_normal(gen, (fin, fout), scale, dtype)}
    a = {"w": axes}
    if bias:
        p["b"] = torch.zeros((fout,), dtype=dtype, device=device_of(gen))
        a["b"] = split_ax(axes)[1]
    return p, a


def norm_init(dim: int, dtype, bias: bool = False, *, device):
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    a = {"scale": "embed"}
    if bias:
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
        a["bias"] = "embed"
    return p, a


def stack_inits(init_fn, gen, repeats: int):
    """``init_fn(gen)`` ``repeats`` times, each leaf stacked on a leading
    'layers' axis (the reference vmaps its init over a key batch).  The
    units' own tensors are let go leaf by leaf as the stack is built, so
    beside the stacked tree only one leaf's units are held at a time (a
    unit of MoE layers at full width is tens of GB)."""
    units = [init_fn(gen) for _ in range(repeats)]
    axes = tree_map(lambda a: "layers," + a if a else "layers", units[0][1])
    skeleton = tree_map(lambda _: 0, units[0][0])
    cols = [tree_leaves(p) for p, _ in units]
    del units
    stacked = []
    for i in range(len(cols[0])):
        stacked.append(torch.stack([c[i] for c in cols]))
        for c in cols:
            c[i] = None
    return tree_unflatten(skeleton, stacked), axes


def merge(*pairs_named):
    """merge(("attn", (p,a)), ("mlp", (p,a)), ...) -> (params, axes)."""
    params, axes = {}, {}
    for name, (p, a) in pairs_named:
        params[name], axes[name] = p, a
    return params, axes


def replicated(t, mesh):
    """A tensor the same on every rank as a replicated DTensor on
    ``mesh`` (a DTensor as it is)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def from_block(local, mesh, place, shape):
    """This rank's block ``local`` of a row-major tensor of ``shape`` as a
    DTensor placed ``place``."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride, n = [], 1
    for d in reversed(shape):        # row-major, computed: no allocation
        stride.append(n)
        n *= max(d, 1)
    return DTensor.from_local(local.contiguous(), mesh, place,
                              run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))


def _relaid(x, shape):
    """DTensor ``x`` with every split that ``x.reshape(shape)`` cannot keep
    gathered (module function ``reshape``)."""
    from torch.distributed.tensor import Replicate, Shard
    k = next((i for i, (a, b) in enumerate(zip(x.shape, shape)) if a != b),
             min(x.ndim, len(shape)))
    mesh = x.device_mesh
    place = [Replicate() if isinstance(p, Shard) and p.dim >= k and (
        p.dim > k or k >= len(shape) or shape[k] % mesh.shape[i]) else p
        for i, p in enumerate(x.placements)]
    return x if place == list(x.placements) else x.redistribute(mesh, place)


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``.  A DTensor split over n ranks along a
    dimension that the reshape changes, where the new dimension there
    does not divide by n (14 query heads from a 896-wide projection split
    16 ways), gathers that dimension first, in the forward and, through a
    hook on the result, in the backward: GSPMD re-lays such a split
    itself, DTensor refuses it."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    y = _relaid(x, shape).reshape(shape)
    if y.requires_grad:
        back = tuple(x.shape)
        y.register_hook(lambda g: _relaid(g, back))
    return y
