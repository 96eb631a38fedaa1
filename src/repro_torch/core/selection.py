"""Channel selection + upload accounting — paper §2.1 "Sort Norms" /
"Process Gradients" / "Update Server" steps (port of
``repro.core.selection``).

``select_gradients`` is the full pipeline for the MLP family: layer
scores → α-quantile threshold → exact edge masks → masked gradients.
``UploadStats.from_masks`` turns masks into the paper's §3 communication
numbers.  A slot-stacked delta (S clients of a round, every leaf
``(S, …)``) runs the same pipeline in one pass
(``core.channels``), and ``UploadStats.from_slot_masks`` gives every
slot's numbers from one host copy of the counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch


from repro_torch.comm import wire
from repro_torch.core import channels


@dataclass
class UploadStats:
    uploaded_params: int          # entries the masks reveal
    total_params: int
    dense_bytes: int              # dense exchange (what FedAvg ships)
    sparse_bytes: int             # cheapest wire encoding of the mask counts
    upload_fraction: float

    @classmethod
    def from_masks(cls, masks: Sequence[dict]) -> "UploadStats":
        """Accounting from boolean masks, counted by *mask* (a revealed
        entry whose value is exactly zero still counts here, though the
        wire, which keeps nonzeros, ships no bytes for it).  ``None``
        entries cost nothing.  All counts reach the host in one copy."""
        leaves = [v for m in masks for v in m.values() if v is not None]
        if not leaves:
            return cls(0, 0, 0, 0, 0.0)
        nnzs = torch.stack([torch.count_nonzero(v)
                            for v in leaves]).tolist()
        return cls._from_counts(nnzs, [int(v.numel()) for v in leaves])

    @classmethod
    def _from_counts(cls, nnzs: Sequence[int], sizes: Sequence[int]
                     ) -> "UploadStats":
        up, total, sparse = 0, 0, 0
        for nnz, size in zip(nnzs, sizes):
            up += int(nnz)
            total += size
            sparse += wire.cheapest_bytes(int(nnz), size, itemsize=4)[1]
        return cls(up, total, total * 4, sparse, up / max(total, 1))

    @classmethod
    def from_slot_masks(cls, masks: Sequence[dict], num: int
                        ) -> List["UploadStats"]:
        """``from_masks`` of slots 0 .. num-1 of slot-stacked masks (every
        leaf ``(S, …)``), the counts of all of them in one host copy."""
        leaves = [v[:num] for m in masks for v in m.values() if v is not None]
        if not leaves:
            return [cls(0, 0, 0, 0, 0.0) for _ in range(num)]
        nnzs = torch.stack([torch.count_nonzero(v.reshape(num, -1), dim=1)
                            for v in leaves], dim=1).tolist()
        sizes = [int(v[0].numel()) for v in leaves]
        return [cls._from_counts(row, sizes) for row in nnzs]


def select_gradients(grads: Sequence[dict], upload_rate: float,
                     selection: str = "positive",
                     score_norm: bool = False,
                     sample_idx: Optional[Sequence] = None,
                     generator: Optional[torch.Generator] = None,
                     neuron_masks=None) -> tuple:
    """The paper's channel-selection pipeline for MLP gradients.

    positive: upload channels with norm above the (1-α)-quantile (top α).
    negative: discard channels below the α-quantile (upload the top 1-α).
    ``sample_idx``/``generator`` feed the sampled quantile path only.
    ``neuron_masks`` (mask-mode SCBFwP): per-hidden-layer keep-masks;
    pruned neurons score ``-inf`` and the quantile runs over the rest.
    A slot-stacked delta (weights ``(S, M, N)``) selects every slot in one
    pass: one threshold a slot, one launch of each kernel.

    Returns (masked_grads, masks, threshold, operands): ``operands`` are
    each weight matrix's ``channels.EdgeOperands``, what the on-device
    upload encoder (``comm.wire.encode_selected``) compacts.
    """
    scores = channels.layer_scores(grads, normalize=score_norm,
                                   neuron_masks=neuron_masks)
    thr = channels.channel_quantile(scores, upload_rate,
                                    selection=selection,
                                    sample_idx=sample_idx,
                                    generator=generator,
                                    masked=neuron_masks is not None)
    ops = channels.edge_operands(grads, scores, thr)
    masked, masks = channels.mask_by_operands(grads, ops)
    return masked, masks, thr, ops
