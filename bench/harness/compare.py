"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference computes from the same
inputs.

A change of parameters is judged leaf by leaf by the gap between its two
norms (the program's and the reference's), over the reference's norm of
that leaf or of the median leaf, whichever is larger (some leaves move
by almost nothing), and the worst leaf counts.  Leaves whose reference
change is under ``NOUGHT`` of the median leaf's are left out: they move
by round-off alone.  An upload, an answer that can be read back, is
judged by the norm of its difference the same way.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

NOUGHT = 1e-3


def norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64).reshape(-1)))


def norm_gaps(got: Sequence[float], want: Sequence[float],
              grad: Optional[Sequence[float]] = None) -> np.ndarray:
    """Per leaf |got - want| / max(want, the median leaf's want), the
    median over the leaves the reference moves; a leaf whose reference
    gradient (``grad``, else ``want``) is under NOUGHT x the median leaf's
    reads nan (left out)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    rule = want if grad is None else np.asarray(grad, np.float64)
    moved = want[want > 0]
    med = float(np.median(moved)) if moved.size else 1.0
    gaps = np.abs(got - want) / np.maximum(want, med)
    return np.where(rule >= NOUGHT * float(np.median(rule)), gaps, np.nan)


def worst_norm_gap(got: Sequence[float], want: Sequence[float],
                   grad: Optional[Sequence[float]] = None) -> float:
    """The worst leaf's ``norm_gaps``."""
    gaps = norm_gaps(got, want, grad)
    return float(np.nanmax(gaps)) if np.isfinite(gaps).any() else float("inf")


def change_gap(start: Sequence[dict], got: Sequence[dict],
               want: Sequence[dict]) -> float:
    """The worst leaf's gap between the norms of the change from ``start``
    (layers of numpy arrays) to ``got`` and to ``want``."""
    g, w = [], []
    for s, a, b in zip(start, got, want):
        for k in sorted(s):
            g.append(norm(np.asarray(a[k], np.float64) - s[k]))
            w.append(norm(np.asarray(b[k], np.float64) - s[k]))
    return worst_norm_gap(g, w)


def decode_payload(payload) -> List[dict]:
    """A wire payload (codec, shape, flat indices or packed bitmap, values
    a leaf; leaves keyed (layer, name)) read back into dense layers."""
    layers: Dict[int, dict] = {}
    for (l, k), lp in zip(payload.keys, payload.layers):
        size = int(np.prod(lp.shape)) if lp.shape else 1
        if lp.codec == "dense":
            flat = np.asarray(lp.values, np.float32).reshape(-1)
        else:
            flat = np.zeros(size, np.float32)
            if lp.codec == "coo":
                flat[np.asarray(lp.idx, np.int64)] = lp.values
            elif lp.codec == "bitmap":
                bits = np.unpackbits(np.asarray(lp.bitmap, np.uint8),
                                     count=size).astype(bool)
                flat[bits] = lp.values
            else:
                raise ValueError(f"unknown codec {lp.codec!r}")
        layers.setdefault(l, {})[k] = flat.reshape(lp.shape)
    return [layers[l] for l in sorted(layers)]


def _dense(upload) -> List[dict]:
    return decode_payload(upload) if hasattr(upload, "layers") else upload


def upload_gaps(got: Sequence,
                want: Sequence[Sequence[dict]]) -> List[float]:
    """The values of one loop's uploads where both sides kept an entry, a
    client each: the worst leaf's |got - want| over those entries, over
    max(|want|, the median leaf's |want|) there.  ``got`` wire payloads
    or dense layers, ``want`` dense layers.  A channel at the threshold
    that one side keeps and the other drops is not compared."""
    if len(got) != len(want):
        return [float("inf")]
    out = []
    for g, w in zip(got, want):
        g = _dense(g)
        pairs = []
        for l in range(len(w)):
            for k in sorted(w[l]):
                a = np.asarray(g[l][k], np.float64)
                b = np.asarray(w[l][k], np.float64)
                if a.shape != b.shape:
                    return [float("inf")]
                both = (a != 0) & (b != 0)
                pairs.append((a[both], b[both]))
        norms = [norm(b) for _, b in pairs]
        med = float(np.median(norms))
        out.append(max(norm(a - b) / max(n, med, 1e-30)
                       for (a, b), n in zip(pairs, norms)))
    return out


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)
