"""Carrying weights between numpy and torch.

The MLP's params are a tuple of per-layer ``{"w": (fan_in, fan_out),
"b": (fan_out,)}`` dicts — the reference's layout
(``repro.models.mlp_net``), so weights move across as numpy arrays and
tests compare like with like (``from_numpy``/``to_numpy``).  The LM zoo's
params are the reference's nested dicts (``repro.models.transformer``),
carried by ``from_numpy_tree``/``to_numpy_tree`` in JAX's flatten order
(``tree_paths``).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

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
    """Parameter count, from the leaves' shapes only."""
    return sum(math.prod(layer["w"].shape) + math.prod(layer["b"].shape)
               for layer in params)


# ---------------------------------------------------------------------------
# Param trees: dicts, lists and tuples of tensors, walked in JAX's pytree
# order — a dict's keys sorted, a list's items in order, ``None`` an empty
# subtree — so leaf i of a port tree is leaf i of the reference's.  The
# one walker of the port: the LM zoo, the optimizers and the server rules
# all go through it.
# ---------------------------------------------------------------------------

def tree_paths(tree, path: Tuple[str, ...] = ()) -> List[tuple]:
    """(path, leaf) of every leaf in flatten order; a path is the tuple of
    keys (list indices as strings) from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_paths(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_paths(v, path + (str(i),))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    """The leaves in flatten order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` in flatten order, each with the
    same places of ``rest`` (whatever stands there, ``None`` too);
    ``tree``'s ``None`` stays ``None`` and its dicts keep their key
    order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: Sequence):
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def from_numpy_tree(tree_np, device):
    """A nested tree of numpy arrays → torch tensors on ``device``, each in
    its array's dtype; a ``bfloat16`` array (JAX's, from ``ml_dtypes``)
    becomes a bf16 tensor through fp32, which holds it exactly."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)
    return tree_unflatten(tree_np, [leaf(a) for a in tree_leaves(tree_np)])


def to_numpy_tree(tree):
    """A nested tree of torch tensors → numpy arrays (one host copy a
    leaf); bf16 leaves come back as fp32, which holds them exactly."""
    def leaf(t):
        t = t.detach()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16
                else t).cpu().numpy()
    return tree_unflatten(tree, [leaf(t) for t in tree_leaves(tree)])
