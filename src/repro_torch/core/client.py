"""Local client training — paper Algorithm 1 "Train the client model".

Port of ``repro.core.client``.  Each client runs plain minibatch SGD on
its private shard for ``epochs`` epochs and reports the delta
G = W_after - W_before.  Where the reference scans over pre-shuffled
batches inside one jit, the port is a Python loop over epochs and
batches with ``torch.autograd.grad`` and an in-place SGD step (the
client's copy of the weights is private, so updating it in place saves
one allocation per step).

Randomness: the reference permutes each epoch with
``jax.random.permutation``.  Torch cannot draw the same stream, so
``perms`` (one index array per epoch) injects the reference's
permutations in parity tests; without it each epoch draws
``torch.randperm`` on ``generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.metrics.auc import binary_cross_entropy
from repro_torch.models.mlp_net import mlp_forward


def bce_loss(params, xb, yb, neuron_masks=None):
    return binary_cross_entropy(mlp_forward(params, xb, neuron_masks), yb)


def epoch_perms(n: int, epochs: int, generator: torch.Generator
                ) -> list:
    """One full permutation of ``range(n)`` per epoch, drawn on the
    (CPU) ``generator`` so the stream does not depend on the device."""
    return [torch.randperm(n, generator=generator) for _ in range(epochs)]


def local_train_impl(params: Tuple[dict, ...], x: torch.Tensor,
                     y: torch.Tensor, lr: float,
                     perms: Optional[Sequence] = None,
                     generator: Optional[torch.Generator] = None,
                     batch_size: int = 256, epochs: int = 1,
                     neuron_masks=None) -> Tuple[dict, ...]:
    """SGD over the client shard; returns the updated params.

    ``perms``: one permutation of ``range(len(x))`` per epoch (numpy or
    tensor); each is cut to the ``(len(x) // batch_size) * batch_size``
    examples the epoch uses, dropping the ragged tail as the reference
    does.  ``None`` draws them with ``epoch_perms`` on ``generator``.
    """
    if perms is None:
        if generator is None:
            raise ValueError("pass perms= or a generator to draw them")
        perms = epoch_perms(x.shape[0], epochs, generator)
    if len(perms) != epochs:
        raise ValueError(f"{len(perms)} permutations for {epochs} epochs")
    n = (x.shape[0] // batch_size) * batch_size
    p = tuple({k: v.detach().clone().requires_grad_(True)
               for k, v in layer.items()} for layer in params)
    leaves = [v for layer in p for v in layer.values()]
    for perm in perms:
        if not isinstance(perm, torch.Tensor):
            perm = torch.from_numpy(np.array(perm, dtype=np.int64))
        perm = perm[:n].to(x.device)
        xb = x[perm].reshape(-1, batch_size, x.shape[1])
        yb = y[perm].reshape(-1, batch_size)
        for i in range(xb.shape[0]):
            grads = torch.autograd.grad(
                bce_loss(p, xb[i], yb[i], neuron_masks), leaves)
            with torch.no_grad():
                for w, g in zip(leaves, grads):
                    w.sub_(lr * g)
    return tuple({k: v.detach() for k, v in layer.items()} for layer in p)


def client_delta(params_before, params_after):
    """The paper's gradient matrix G for one training loop."""
    return tuple({k: layer_after[k] - layer_before[k] for k in layer_after}
                 for layer_before, layer_after in zip(params_before,
                                                      params_after))
