"""Sparse channel-exchange wire formats — what SCBF actually ships.

Port of ``repro.comm.wire`` (see its docstring and docs/WIRE_FORMAT.md).
Three codecs per leaf, cheapest wins:

  ``coo``     int32 flat index + value per kept entry → nnz·(4 + itemsize)
  ``bitmap``  packed 1 bit per entry + kept values    → ceil(size/8) + nnz·itemsize
  ``dense``   every entry                              → size·itemsize

Encoding keeps *nonzero* entries (``np.flatnonzero``) and is lossless.
``encode_round`` is the same encoding of the clients of a round at once,
from the selection's slot-stacked operands: the select-compact kernel
counts every (weight leaf, slot)'s kept *and* nonzero entries on the
device in one launch, the counts pick the codecs, and only the coo and
bitmap pairs are compacted (row-major, at their counts, one launch) and
cross to the host; ``encode_selected`` is a round of one slot.
Payloads hold host numpy buffers — they
model bytes crossing the network — as in the reference.  Where the
reference keeps a JAX treedef, a ``Payload`` keeps its layer-key
structure: ``(layer, name)`` pairs in the order JAX flattens a tuple of
dicts (layers in order, keys sorted), so leaf i is the same leaf in both
packages.  Integrity sealing and
checksums come with the faults slice (ROADMAP A11).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.channels import slot_groups, slot_range
from repro_torch.kernels.select_mask import compact_count, compact_scatter

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


def _leaf_from_compact(shape: Tuple[int, ...], nnz: int,
                       nz: Optional[np.ndarray], values: Optional[np.ndarray],
                       dense: Optional[np.ndarray]) -> LayerPayload:
    """``encode_leaf`` of a masked fp32 leaf of ``shape`` from its nonzero
    count and, for coo and bitmap, its ``nnz`` row-major flat indices and
    values (host arrays); dense copies ``dense``, the masked leaf on the
    host."""
    size = int(np.prod(shape, dtype=np.int64))
    codec, nbytes = cheapest_bytes(nnz, size, 4)
    if codec == "dense":
        return LayerPayload(codec, shape, np.dtype(np.float32), size,
                            nbytes, idx=None, bitmap=None,
                            values=dense.reshape(-1).copy())
    if codec == "coo":
        return LayerPayload(codec, shape, np.dtype(np.float32), nnz, nbytes,
                            idx=nz, bitmap=None, values=values)
    mask = np.zeros(size, np.uint8)
    mask[nz] = 1
    return LayerPayload(codec, shape, np.dtype(np.float32), nnz, nbytes,
                        idx=None, bitmap=np.packbits(mask), values=values)


def encode_selected(masked: Sequence[dict], operands: Sequence) -> Payload:
    """``encode(masked)`` for a channel-selected delta, field for field,
    with the weight leaves compacted on the device, count first.

    ``operands[l]`` is layer l's edge rule (``core.channels.EdgeOperands``
    — g, row, col, thr, rest — in the geometry of ``masked[l]["w"]``);
    its kept-and-nonzero entries are exactly ``np.flatnonzero`` of the
    masked leaf.  This is ``encode_round`` of a round of one slot: one
    count launch over the weight leaves, one host read of the counts, one
    scatter launch of the coo and bitmap leaves at their counts.
    """
    one = [{k: v[None] for k, v in layer.items() if v is not None}
           for layer in masked]
    ops = [op._replace(g=op.g[None], col=op.col[None],
                       thr=torch.as_tensor(op.thr, device=op.g.device)
                       .reshape(1),
                       rest=torch.as_tensor(op.rest, device=op.g.device)
                       .reshape(1))
           for op in operands]
    return encode_round(one, ops, 1)[0]


def encode_round(masked: Sequence[dict], operands: Sequence, num: int
                 ) -> List[Payload]:
    """``encode`` of slots 0 .. num-1 of a slot-stacked round (every leaf
    ``(S, …)``, operands slot-stacked as ``core.channels.edge_operands``
    gives them: a row of shape ``(M,)`` serves every slot): one payload a
    slot, each byte for byte ``encode`` of that slot.

    One count launch of the select-compact kernel covers every (weight
    leaf, slot < num) pair; one host read of the counts picks every pair's
    codec; one scatter launch compacts the coo and bitmap pairs, each at
    capacity = its count (no tail), and its buffer reaches the host in one
    copy.  A round of more pairs than one launch takes is encoded a group
    of slots at a time (``core.channels.slot_groups``).  A weight leaf with a dense pair, and every bias leaf (vectors
    no kernel computes, encoded by ``encode_leaf`` on the host), cross to
    the host in one copy a leaf.  Weight leaves are fp32.  Under DP the
    operands' ``g`` is the noised leaf, so what is compacted is what the
    mechanism released.
    """
    for l in range(len(operands)):
        if masked[l]["w"].dtype != torch.float32:
            raise TypeError(f"the encoder takes fp32 weight leaves, got "
                            f"{masked[l]['w'].dtype}")
    return [p for a, b in slot_groups(num, len(operands))
            for p in _encode_slots(masked, operands, a, b)]


def _encode_slots(masked: Sequence[dict], operands: Sequence, a: int,
                  b: int) -> List[Payload]:
    """``encode_round`` of slots [a, b), within one launch of each of
    the select-compact kernel's passes."""
    keys = flat_keys(masked)
    masked = tuple({k: v[a:b] for k, v in layer.items()} for layer in masked)
    ops = slot_range(operands, a, b)
    num = b - a
    shapes = [tuple(op.g.shape[1:]) for op in ops]
    nnz, host, dense = {}, {}, {}
    if ops:
        cc = compact_count(ops, drop_zeros=True)
        counts = cc.counts.tolist()
        nnz = dict(zip(cc.pairs, counts))
        codec = {p: cheapest_bytes(c, int(np.prod(shapes[p[0]])), 4)[0]
                 for p, c in nnz.items()}
        sparse = [k for k, p in enumerate(cc.pairs)
                  if nnz[p] and codec[p] != "dense"]
        if sparse:
            buf, views = compact_scatter(cc, [counts[k] for k in sparse],
                                         sparse)
            flat = buf.cpu().numpy()
            for k, (idx, vals) in zip(sparse, views):
                at, vat = idx.storage_offset(), vals.storage_offset()
                host[cc.pairs[k]] = (flat[at:at + counts[k]],
                                     flat[vat:vat + counts[k]]
                                     .view(np.float32))
        for l in sorted({p[0] for p, c in codec.items() if c == "dense"}):
            dense[l] = _host(masked[l]["w"])
    others = {(l, k): _host(masked[l][k]) for l, k in keys if k != "w"}
    empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
    payloads = []
    for s in range(num):
        layers = []
        for l, k in keys:
            if k == "w":
                nz, values = host.get((l, s), empty)
                d = dense.get(l)
                layers.append(_leaf_from_compact(
                    shapes[l], int(nnz[(l, s)]), nz, values,
                    None if d is None else d[s]))
            else:
                layers.append(encode_leaf(others[(l, k)][s]))
        payloads.append(Payload(keys, tuple(layers)))
    return payloads


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
