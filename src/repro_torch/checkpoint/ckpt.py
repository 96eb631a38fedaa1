"""Tree checkpoints in one ``.npz`` (port of ``repro.checkpoint.ckpt``).

A tree is tuples, lists and dicts of tensors (or arrays); its leaves are
stored under the reference's '/'-joined key paths — dict keys sorted,
sequences by index, ``None`` no leaf — so the model's layer dicts are
``0/b``, ``0/w``, ``1/b``, …, beside ``__step__``.  A checkpoint written
by either package loads in the other.  bf16 leaves are stored as fp32
(lossless; numpy has no bf16) and restored to the dtype of the tree they
load into.  The file is written to ``<path>.tmp.npz`` and moved into
place, so a reader never sees half a checkpoint.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _flat(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) of every leaf, in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)          # bf16 -> fp32, lossless
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _flat(tree)}


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    flat = _flatten(tree)
    flat["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _restore(tree: Any, data, path: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf read from ``data``, on the
    leaf's device and in its dtype (a non-tensor leaf gets the array)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _restore(v, data, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(v, data, path + (str(i),))
                          for i, v in enumerate(tree))
    arr = data["/".join(path)]
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=tree.device,
                                                  dtype=tree.dtype)
    return arr


def load_checkpoint(path: str, like: Any):
    """Restore into the structure of ``like`` (its leaves' devices and
    dtypes); returns (tree, step)."""
    data = np.load(path)
    step = int(data["__step__"]) if "__step__" in data else 0
    return _restore(like, data), step
