"""The paper's model family: an L-layer MLP over binary medication features.

Port of ``repro.models.mlp_net``.  Params are a tuple of per-layer dicts
``{"w": (fan_in, fan_out), "b": (fan_out,)}`` — the structure the SCBF
channel algebra (``repro_torch.core.channels``) is defined over.  Forward
is ReLU-activated with a single logit output.  ``neuron_masks`` (mask-mode
SCBFwP) multiplies the post-ReLU activations, as in the reference.

Slot-stacked params (the batched engine: S clients of a round at once)
hold ``w`` as ``(S, fan_in, fan_out)`` and ``b`` as ``(S, fan_out)``; the
input is then ``(S, batch, fan_in)``, every product is one batched
``torch.matmul``, and the bias broadcasts as ``b[:, None, :]``.  The
``neuron_masks`` are shared by all slots.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def init_mlp(features: Sequence[int], generator: torch.Generator,
             device="cpu") -> Tuple[dict, ...]:
    """He-init an MLP with the given feature sizes (incl. input and output).

    Draws on ``generator`` (a CPU generator, so a seed gives the same
    weights whatever the device), then moves the weights to ``device``.
    """
    params = []
    for fin, fout in zip(features[:-1], features[1:]):
        w = torch.randn((fin, fout), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / fin)
        b = torch.zeros((fout,), dtype=torch.float32)
        params.append({"w": w.to(device), "b": b.to(device)})
    return tuple(params)


def _affine(h: torch.Tensor, layer: dict) -> torch.Tensor:
    b = layer["b"]
    return h @ layer["w"] + (b[:, None, :] if b.ndim == 2 else b)


def mlp_forward(params: Sequence[dict], x: torch.Tensor,
                neuron_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """Returns logits of shape (batch,) for a single-output head, else
    (batch, fan_out); slot-stacked params give (S, batch[, fan_out])."""
    h = x
    for i, layer in enumerate(params):
        h = _affine(h, layer)
        if i < len(params) - 1:
            h = torch.relu(h)
            if neuron_masks is not None:
                h = h * neuron_masks[i]
    return h[..., 0] if h.shape[-1] == 1 else h


def mlp_activations(params: Sequence[dict], x: torch.Tensor,
                    neuron_masks: Optional[Sequence[torch.Tensor]] = None):
    """Post-ReLU (mask-applied) activations per hidden layer (for APoZ
    pruning)."""
    acts = []
    h = x
    for i, layer in enumerate(params):
        h = _affine(h, layer)
        if i < len(params) - 1:
            h = torch.relu(h)
            if neuron_masks is not None:
                h = h * neuron_masks[i]
            acts.append(h)
    return acts


def hidden_sizes(params: Sequence[dict]) -> Tuple[int, ...]:
    return tuple(int(layer["w"].shape[1]) for layer in params[:-1])
