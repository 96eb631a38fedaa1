"""Runtime finite and validity checks of debug runs (``debug_checks``;
port of ``repro.obs.checks``).

The static gate (shapelint) holds the padding and mask discipline at
review time; these checks catch at run time what it cannot see: a
nonfinite value (inf or nan from an all-masked round, an unguarded
denominator) or a validity-mask bug that corrupts the aggregated
parameters.

The checks run on the host at chunk boundaries, on values the training
loop has already offloaded (the parameters after a chunk, the round's
metrics dicts).  Nothing enters the captured round: with
``TrainConfig.debug_checks`` on or off the device program is the same,
so a checked run is bitwise its unchecked one.

``verify_round`` raises :class:`DebugCheckError` naming the offending
leaf (``0/w``: layer 0's weight), its nan and inf counts and the
boundary, so a poisoned run fails at the first corrupted chunk.
"""
from __future__ import annotations

from typing import Any, Iterable, List, Optional, Tuple

import numpy as np
import torch


class DebugCheckError(AssertionError):
    """A finite/validity assertion failed at a chunk boundary."""


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> List[Tuple[str, Any]]:
    """(label, leaf) of every leaf in the reference's flatten order: dict
    keys sorted, a named tuple by field, sequences by index, ``None`` no
    leaf; labels are the '/'-joined path (``<root>`` for a bare leaf)."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        return [x for k, v in zip(tree._fields, tree)
                for x in _leaves(v, path + (k,))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, path + (str(i),))]
    return [("/".join(path) or "<root>", tree)]


def _check_leaf(label: str, leaf: Any, where: str) -> None:
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
    else:
        arr = np.asarray(leaf)
    if not np.issubdtype(arr.dtype, np.floating):
        return
    finite = np.isfinite(arr)
    if finite.all():
        return
    bad = arr[~finite]
    n_nan = int(np.count_nonzero(np.isnan(bad)))
    n_inf = bad.size - n_nan
    raise DebugCheckError(
        f"debug_checks: non-finite values at {where}: leaf '{label}' "
        f"has {n_nan} nan / {n_inf} inf of {arr.size} elements "
        f"(dtype {arr.dtype}) — an SL006-class escape; check masked "
        "denominators and guards on the aggregation path")


def check_finite(tree: Any, *, where: str) -> None:
    """Assert every floating leaf of ``tree`` is finite."""
    for label, leaf in _leaves(tree):
        _check_leaf(label, leaf, where)


def check_participants(count: Any, p_count: Optional[int], *,
                       where: str) -> None:
    """Assert the masked participant tally matches the live count: a
    disagreement means a validity mask was widened or narrowed between
    padding and aggregation."""
    if count is None or p_count is None:
        return
    got = int(count.item() if isinstance(count, torch.Tensor) else count)
    if got != int(p_count):
        raise DebugCheckError(
            f"debug_checks: participant accounting skew at {where}: "
            f"Σvalid = {got} but the cohort has {p_count} live "
            "slot(s) — a validity mask was corrupted between padding "
            "and aggregation")


def verify_round(params: Any, metrics: Any = None, *,
                 where: str,
                 p_count: Optional[int] = None,
                 participants: Any = None) -> None:
    """One chunk-boundary verification: params and metrics finite, and
    (when both are known) the participant tally consistent."""
    check_finite(params, where=f"{where} [params]")
    if metrics is not None:
        check_finite(metrics, where=f"{where} [metrics]")
    check_participants(participants, p_count, where=where)


def verify_records(records: Iterable[Any], *, where: str) -> None:
    """Check the floating fields of host-side loop records."""
    for i, rec in enumerate(records):
        for name in ("loss", "auc_roc", "auc_pr", "train_loss"):
            v = getattr(rec, name, None)
            if v is None:
                continue
            f = float(v)
            if f != f or f in (float("inf"), float("-inf")):
                raise DebugCheckError(
                    f"debug_checks: non-finite record field "
                    f"'{name}'={f} at {where} (record {i})")
