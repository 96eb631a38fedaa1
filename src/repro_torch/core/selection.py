"""Channel selection + upload accounting — paper §2.1 "Sort Norms" /
"Process Gradients" / "Update Server" steps (port of
``repro.core.selection``).

``select_gradients`` is the full pipeline for the MLP family: layer
scores → α-quantile threshold → exact edge masks → masked gradients.
``UploadStats.from_masks`` turns masks into the paper's §3 communication
numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

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
        up, total, sparse = 0, 0, 0
        for nnz, v in zip(nnzs, leaves):
            size = int(v.numel())
            up += int(nnz)
            total += size
            sparse += wire.cheapest_bytes(int(nnz), size, itemsize=4)[1]
        return cls(up, total, total * 4, sparse, up / max(total, 1))


def select_gradients(grads: Sequence[dict], upload_rate: float,
                     selection: str = "positive",
                     score_norm: bool = False,
                     sample_idx: Optional[Sequence] = None,
                     generator: Optional[torch.Generator] = None,
                     neuron_masks=None
                     ) -> Tuple[list, list, torch.Tensor]:
    """The paper's channel-selection pipeline for MLP gradients.

    positive: upload channels with norm above the (1-α)-quantile (top α).
    negative: discard channels below the α-quantile (upload the top 1-α).
    ``sample_idx``/``generator`` feed the sampled quantile path only.

    Returns (masked_grads, masks, threshold).
    """
    scores = channels.layer_scores(grads, normalize=score_norm,
                                   neuron_masks=neuron_masks)
    thr = channels.channel_quantile(scores, upload_rate,
                                    selection=selection,
                                    sample_idx=sample_idx,
                                    generator=generator,
                                    masked=neuron_masks is not None)
    masked, masks = channels.apply_channel_mask(grads, scores, thr)
    return masked, masks, thr
