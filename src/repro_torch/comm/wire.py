"""Sparse channel-exchange wire formats — what SCBF actually ships.

Port of ``repro.comm.wire`` (see its docstring and docs/WIRE_FORMAT.md).
Three codecs per leaf, cheapest wins:

  ``coo``     int32 flat index + value per kept entry → nnz·(4 + itemsize)
  ``bitmap``  packed 1 bit per entry + kept values    → ceil(size/8) + nnz·itemsize
  ``dense``   every entry                              → size·itemsize

Encoding keeps *nonzero* entries (``np.flatnonzero``) and is lossless.
Payloads hold host numpy buffers — they model bytes crossing the network —
as in the reference.  Where the reference keeps a JAX treedef, a
``Payload`` keeps its layer-key structure: ``(layer, name)`` pairs in the
order JAX flattens a tuple of dicts (layers in order, keys sorted), so
leaf i is the same leaf in both packages.  Integrity sealing and
checksums come with the faults slice (ROADMAP A11).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

INDEX_BYTES = 4                      # int32 flat index (coo)

CODECS = ("coo", "bitmap", "dense")

Key = Tuple[int, str]


class PayloadError(ValueError):
    """A wire payload failed structural validation (raised before any
    index reaches a scatter, so a corrupt payload fails instead of being
    applied in part)."""


def coo_bytes(nnz: int, size: int, itemsize: int = 4) -> int:
    return nnz * (INDEX_BYTES + itemsize)


def bitmap_bytes(nnz: int, size: int, itemsize: int = 4) -> int:
    return math.ceil(size / 8) + nnz * itemsize


def dense_bytes(size: int, itemsize: int = 4) -> int:
    return size * itemsize


def codec_bytes(codec: str, nnz: int, size: int, itemsize: int = 4) -> int:
    if codec == "coo":
        return coo_bytes(nnz, size, itemsize)
    if codec == "bitmap":
        return bitmap_bytes(nnz, size, itemsize)
    if codec == "dense":
        return dense_bytes(size, itemsize)
    raise ValueError(f"unknown codec {codec!r}")


def cheapest_bytes(nnz: int, size: int, itemsize: int = 4
                   ) -> Tuple[str, int]:
    """(codec, bytes) of the cheapest encoding for nnz kept of size."""
    return min(((c, codec_bytes(c, nnz, size, itemsize)) for c in CODECS),
               key=lambda cb: cb[1])


@dataclass(frozen=True)
class LayerPayload:
    """One leaf of a delta on the wire."""

    codec: str                       # coo | bitmap | dense
    shape: Tuple[int, ...]
    dtype: np.dtype
    nnz: int                         # kept (transmitted-value) entries
    nbytes: int                      # wire size under ``codec``
    idx: Optional[np.ndarray]        # (nnz,) int32 flat indices — coo only
    bitmap: Optional[np.ndarray]     # packed uint8 mask — bitmap only
    values: np.ndarray               # kept values (coo/bitmap) or full flat

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

    def flat_indices(self) -> np.ndarray:
        """int32 flat indices of the transmitted entries (any codec)."""
        if self.codec == "coo":
            return self.idx
        if self.codec == "bitmap":
            mask = np.unpackbits(self.bitmap, count=self.size)
            return np.flatnonzero(mask).astype(np.int32)
        return np.arange(self.size, dtype=np.int32)


@dataclass(frozen=True)
class Payload:
    """One client's upload: its leaves in ``keys`` order."""

    keys: Tuple[Key, ...]
    layers: Tuple[LayerPayload, ...]

    @property
    def nbytes(self) -> int:
        return sum(lp.nbytes for lp in self.layers)

    @property
    def dense_nbytes(self) -> int:
        return sum(dense_bytes(lp.size, lp.dtype.itemsize)
                   for lp in self.layers)


def flat_keys(tree: Sequence[dict]) -> Tuple[Key, ...]:
    """(layer, name) of every non-None leaf, in JAX's flatten order."""
    return tuple((l, k) for l, layer in enumerate(tree)
                 for k in sorted(layer) if layer[k] is not None)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def encode_leaf(leaf, codec: str = "auto") -> LayerPayload:
    """Encode one masked array; zeros are treated as masked-out."""
    a = _host(leaf)
    flat = a.reshape(-1)
    nz = np.flatnonzero(flat).astype(np.int32)
    nnz, size, itemsize = int(nz.size), int(flat.size), flat.dtype.itemsize
    if codec == "auto":
        codec, nbytes = cheapest_bytes(nnz, size, itemsize)
    else:
        nbytes = codec_bytes(codec, nnz, size, itemsize)
    if codec == "coo":
        return LayerPayload(codec, a.shape, flat.dtype, nnz, nbytes,
                            idx=nz, bitmap=None, values=flat[nz].copy())
    if codec == "bitmap":
        mask = np.zeros(size, np.uint8)
        mask[nz] = 1
        return LayerPayload(codec, a.shape, flat.dtype, nnz, nbytes,
                            idx=None, bitmap=np.packbits(mask),
                            values=flat[nz].copy())
    return LayerPayload(codec, a.shape, flat.dtype, size, nbytes,
                        idx=None, bitmap=None, values=flat.copy())


def encode(tree: Sequence[dict], codec: str = "auto") -> Payload:
    """Encode a masked delta (tuple of layer dicts); per leaf the cheapest
    codec wins."""
    keys = flat_keys(tree)
    return Payload(keys, tuple(encode_leaf(tree[l][k], codec)
                               for l, k in keys))


def validate_layer(lp: LayerPayload, leaf_shape: Optional[Tuple[int, ...]]
                   = None) -> None:
    """Structural validation of one wire leaf; raises ``PayloadError``.

    Checks codec name, nnz against buffer sizes, index dtype and bounds
    ``[0, size)``, bitmap length and popcount, and (when ``leaf_shape``
    is given) the declared shape against the server's parameter leaf.
    """
    if lp.codec not in CODECS:
        raise PayloadError(f"unknown codec {lp.codec!r}")
    if leaf_shape is not None and tuple(lp.shape) != tuple(leaf_shape):
        raise PayloadError(f"payload shape {tuple(lp.shape)} != "
                           f"param shape {tuple(leaf_shape)}")
    size = lp.size
    if not 0 <= lp.nnz <= size:
        raise PayloadError(f"nnz {lp.nnz} outside [0, {size}]")
    values = np.asarray(lp.values)
    if values.ndim != 1:
        raise PayloadError(f"values must be 1-D, got shape {values.shape}")
    if np.dtype(values.dtype) != np.dtype(lp.dtype):
        raise PayloadError(f"values dtype {values.dtype} != declared "
                           f"{np.dtype(lp.dtype)}")
    if lp.codec == "dense":
        if values.size != size:
            raise PayloadError(f"dense values size {values.size} != "
                               f"leaf size {size}")
        return
    if values.size != lp.nnz:
        raise PayloadError(f"{lp.codec} values size {values.size} != "
                           f"nnz {lp.nnz}")
    if lp.codec == "coo":
        idx = lp.idx
        if idx is None or not np.issubdtype(np.asarray(idx).dtype,
                                            np.integer):
            raise PayloadError("coo indices missing or non-integral")
        idx = np.asarray(idx)
        if idx.size != lp.nnz:
            raise PayloadError(f"coo idx size {idx.size} != nnz {lp.nnz}")
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= size):
            raise PayloadError(
                f"coo index out of bounds: [{int(idx.min())}, "
                f"{int(idx.max())}] not within [0, {size})")
        if np.unique(idx).size != idx.size:
            raise PayloadError("coo indices repeat")
        return
    bitmap = lp.bitmap                                    # codec == bitmap
    if bitmap is None:
        raise PayloadError("bitmap payload missing its bitmap")
    bitmap = np.asarray(bitmap)
    if bitmap.dtype != np.uint8 or bitmap.size != math.ceil(size / 8):
        raise PayloadError(f"bitmap buffer {bitmap.dtype}[{bitmap.size}] "
                           f"!= uint8[{math.ceil(size / 8)}]")
    pop = int(np.unpackbits(bitmap, count=size).sum())
    tail = int(np.unpackbits(bitmap)[size:].sum())
    if pop != lp.nnz or tail:
        raise PayloadError(f"bitmap popcount {pop} (+{tail} tail bits) "
                           f"!= nnz {lp.nnz}")


def validate_payload(payload: Payload, params=None) -> None:
    """Validate every leaf of a payload (``PayloadError`` on failure);
    with ``params``, also the leaf count and shapes against them."""
    shapes = None
    if params is not None:
        keys = flat_keys(params)
        if len(payload.layers) != len(keys):
            raise PayloadError(
                f"payload has {len(payload.layers)} leaves, params have "
                f"{len(keys)}")
        shapes = [tuple(params[l][k].shape) for l, k in keys]
    for i, lp in enumerate(payload.layers):
        try:
            validate_layer(lp, shapes[i] if shapes else None)
        except PayloadError as e:
            raise PayloadError(f"leaf {i}: {e}") from None


def decode_leaf(lp: LayerPayload, device="cpu") -> torch.Tensor:
    validate_layer(lp)
    if lp.codec == "dense":
        flat = lp.values
    else:
        flat = np.zeros(lp.size, lp.dtype)
        flat[lp.flat_indices()] = lp.values
    return torch.from_numpy(flat.reshape(lp.shape).copy()).to(device)


def decode(payload: Payload, device="cpu") -> Tuple[dict, ...]:
    """Lossless inverse of encode: masked entries come back exact zeros."""
    layers = [dict() for _ in range(max((l for l, _ in payload.keys),
                                        default=-1) + 1)]
    for (l, k), lp in zip(payload.keys, payload.layers):
        layers[l][k] = decode_leaf(lp, device)
    return tuple(layers)


def apply_payloads(params: Sequence[dict], payloads: Sequence[Payload]
                   ) -> Tuple[dict, ...]:
    """W <- W + Σ_k decode(payload_k), without materialising K dense deltas.

    Per leaf the client deltas accumulate **delta-first in client order**
    into one zero fp32 buffer, which is then added to the parameters once
    — the reference's order of additions, coordinate by coordinate,
    whichever codec each client's encoder picked.  A coo/bitmap client is
    one ``index_add_`` of its (index, value) buffers: its indices are
    unique (validated), so each address receives one addition and the
    scatter is deterministic on every device; a dense client is one
    vector add.  (A single scatter over the indices of all clients would
    add repeated indices with float atomics on CUDA, in an order that
    changes from run to run.)
    """
    keys = flat_keys(params)
    for p in payloads:
        if len(p.layers) != len(keys):
            raise PayloadError("payload structure does not match params")
        for i, lp in enumerate(p.layers):
            l, k = keys[i]
            validate_layer(lp, tuple(params[l][k].shape))
    out = [dict(layer) for layer in params]
    for i, (l, k) in enumerate(keys):
        leaf = params[l][k]
        if not payloads:
            continue
        flat = leaf.reshape(-1).to(torch.float32)
        acc = torch.zeros_like(flat)
        for p in payloads:
            lp = p.layers[i]
            vals = torch.from_numpy(
                np.asarray(lp.values, np.float32)).to(leaf.device)
            if lp.codec == "dense":
                acc = acc + vals
            else:
                idx = torch.from_numpy(
                    lp.flat_indices().astype(np.int64)).to(leaf.device)
                acc.index_add_(0, idx, vals)
        out[l][k] = (flat + acc).reshape(leaf.shape).to(leaf.dtype)
    return tuple(out)
