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

``masked_local_train_impl`` weights each example (1 real, 0 padding: the
padded cohort of ``fed.cohort``), and ``local_train_slots`` trains the S
clients of a round at once on slot-stacked params — the counterpart of
the reference's ``jax.vmap`` of the two bodies (``repro.fed.engine``).

``with_loss=True`` (the device telemetry, ``repro_torch.obs``) also
returns the mean training loss: the forward value each step's backward
pass already computes, accumulated detached on the device (no host
read, so it runs under capture), so the parameter trajectory is bitwise
the one without it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.metrics.auc import bce_elementwise, binary_cross_entropy
from repro_torch.models.mlp_net import mlp_forward


def bce_loss(params, xb, yb, neuron_masks=None):
    return binary_cross_entropy(mlp_forward(params, xb, neuron_masks), yb)


def masked_bce_loss(params, xb, yb, wb, neuron_masks=None):
    """Weighted-mean BCE; zero-weight (padding) examples contribute 0."""
    per = bce_elementwise(mlp_forward(params, xb, neuron_masks), yb)
    return torch.sum(per * wb, axis=0) / torch.clamp(torch.sum(wb, axis=0),
                                                      min=1.0)


def epoch_perms(n: int, epochs: int, generator: torch.Generator
                ) -> list:
    """One full permutation of ``range(n)`` per epoch, drawn on the
    (CPU) ``generator`` so the stream does not depend on the device."""
    return [torch.randperm(n, generator=generator) for _ in range(epochs)]


def _as_index(perm, device) -> torch.Tensor:
    if not isinstance(perm, torch.Tensor):
        perm = torch.from_numpy(np.array(perm, dtype=np.int64))
    return perm.to(device)


def local_train_impl(params: Tuple[dict, ...], x: torch.Tensor,
                     y: torch.Tensor, lr: float,
                     perms: Optional[Sequence] = None,
                     generator: Optional[torch.Generator] = None,
                     batch_size: int = 256, epochs: int = 1,
                     neuron_masks=None, with_loss: bool = False):
    """SGD over the client shard; returns the updated params.

    ``perms``: one permutation of ``range(len(x))`` per epoch (numpy or
    tensor); each is cut to the ``(len(x) // batch_size) * batch_size``
    examples the epoch uses, dropping the ragged tail as the reference
    does.  ``None`` draws them with ``epoch_perms`` on ``generator``.
    ``with_loss``: returns ``(params, mean loss)``, the mean over the
    steps taken (a 0-d fp32 tensor on the device).
    """
    return masked_local_train_impl(params, x, y, None, lr, perms=perms,
                                   generator=generator,
                                   batch_size=batch_size, epochs=epochs,
                                   neuron_masks=neuron_masks,
                                   with_loss=with_loss)


def masked_local_train_impl(params: Tuple[dict, ...], x: torch.Tensor,
                            y: torch.Tensor, w: Optional[torch.Tensor],
                            lr: float, perms: Optional[Sequence] = None,
                            generator: Optional[torch.Generator] = None,
                            batch_size: int = 256, epochs: int = 1,
                            neuron_masks=None, with_loss: bool = False):
    """``local_train_impl`` with per-example weights ``w`` (1 real, 0
    padding; ``None``: the unweighted loss).  Batches come from the
    padded shard and the weighted mean renormalises by the real examples
    of each batch, ``max(Σw, 1)``: a batch of pure padding is a no-op.
    ``with_loss``: returns ``(params, mean loss)``; with ``w`` the mean is
    example-weighted over the steps, Σ loss·Σw / max(ΣΣw, 1)."""
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
    num = den = torch.zeros((), dtype=torch.float32, device=x.device)
    for perm in perms:
        perm = _as_index(perm, x.device)[:n]
        xb = x[perm].reshape(-1, batch_size, x.shape[1])
        yb = y[perm].reshape(-1, batch_size)
        wb = None if w is None else w[perm].reshape(-1, batch_size)
        for i in range(xb.shape[0]):
            loss = bce_loss(p, xb[i], yb[i], neuron_masks) if wb is None \
                else masked_bce_loss(p, xb[i], yb[i], wb[i], neuron_masks)
            _sgd_step(leaves, torch.autograd.grad(loss, leaves), lr)
            if with_loss:
                if wb is None:
                    num = num + loss.detach()
                else:
                    wsum = torch.sum(wb[i], axis=0)
                    num = num + loss.detach() * wsum
                    den = den + wsum
    out = tuple({k: v.detach() for k, v in layer.items()} for layer in p)
    if not with_loss:
        return out
    if w is None:
        return out, num / max((n // batch_size) * epochs, 1)
    return out, num / torch.clamp(den, min=1.0)


def _sgd_step(leaves, grads, lr) -> None:
    """v ← v - lr·g in place; ``lr`` a float or a 0-d fp32 tensor on the
    leaves' device (the same fp32 product either way)."""
    with torch.no_grad():
        for v, g in zip(leaves, grads):
            v.sub_(lr * g)


def local_train_slots(params: Tuple[dict, ...], x: torch.Tensor,
                      y: torch.Tensor, lr, perms,
                      w: Optional[torch.Tensor] = None,
                      valid: Optional[torch.Tensor] = None,
                      batch_size: int = 256, epochs: int = 1,
                      neuron_masks=None,
                      clients: Optional[torch.Tensor] = None,
                      with_loss: bool = False):
    """SGD for S clients at once: the counterpart of ``jax.vmap`` of
    ``local_train_impl`` (``w`` None) or ``masked_local_train_impl``.

    ``params``: slot-stacked layer dicts (``w`` (S, in, out), ``b``
    (S, out)); ``x`` (S, n, d), ``y`` (S, n), ``w`` (S, n) example
    weights — or, with ``clients`` (S,) int64, the whole padded cohort
    ``(K, n, d)`` of which slot s trains on row ``clients[s]``; ``perms``
    (S, epochs, n) — slot s's permutation of ``range(n)`` for each epoch,
    cut to ``(n // batch_size) * batch_size``.  ``lr``: a float, or a 0-d
    fp32 tensor on the device (what a captured round reads; bitwise the
    float).  Each epoch's batches are gathered once, as
    ``(batches, S, batch, d)``.
    A step's backward pass is of the *sum* of the slots' losses: the
    slots share no parameter, so each gets exactly its own gradient; one
    in-place SGD update then covers every slot.  ``valid`` (S,) bool
    marks the real slots of a padded bucket: a padded slot's loss is
    zeroed, so it takes no step (its output is dropped all the same).
    Reductions name their axis: the examples' (1), never the slots'.
    ``neuron_masks`` are shared by all slots.
    Returns the updated slot-stacked params; with ``with_loss``,
    ``(params, (S,) mean losses)``: each slot's loss is taken detached
    before the sum that is backpropagated and accumulated on the device,
    its mean as ``local_train_impl``'s (``w`` None) or
    ``masked_local_train_impl``'s.
    """
    s_count = x.shape[0] if clients is None else clients.shape[0]
    n_all = x.shape[1]
    perms = _as_index(perms, x.device)
    if tuple(perms.shape) != (s_count, epochs, n_all):
        raise ValueError(f"perms of shape {tuple(perms.shape)}, want "
                         f"{(s_count, epochs, n_all)}")
    n = (n_all // batch_size) * batch_size
    p = tuple({k: v.detach().clone(memory_format=torch.contiguous_format)
               .requires_grad_(True) for k, v in layer.items()}
              for layer in params)
    leaves = [v for layer in p for v in layer.values()]
    slot = (torch.arange(s_count, device=x.device) if clients is None
            else clients)[None, :, None]
    if valid is None:
        valid = torch.ones(s_count, dtype=torch.bool, device=x.device)
    live = valid[:, None]
    num = den = torch.zeros(s_count, dtype=torch.float32, device=x.device)
    for e in range(epochs):
        # (batches, S, batch): batch i of every slot is one contiguous block
        idx = perms[:, e, :n].reshape(s_count, -1, batch_size).transpose(0, 1)
        xb, yb = x[slot, idx], y[slot, idx]
        wb = None if w is None else w[slot, idx]
        for i in range(idx.shape[0]):
            per = torch.where(live, bce_elementwise(
                mlp_forward(p, xb[i], neuron_masks), yb[i]), 0.0)
            if wb is None:
                slot_loss = torch.mean(per, axis=1)
            else:
                wi = torch.where(live, wb[i], 0.0)
                wsum = torch.sum(wi, axis=1)
                slot_loss = torch.sum(per * wi, axis=1) / torch.clamp(
                    wsum, min=1.0)
            loss = torch.sum(slot_loss)
            _sgd_step(leaves, torch.autograd.grad(loss, leaves), lr)
            if with_loss:
                if wb is None:
                    num = num + slot_loss.detach()
                else:
                    num = num + slot_loss.detach() * wsum
                    den = den + wsum
    out = tuple({k: v.detach() for k, v in layer.items()} for layer in p)
    if not with_loss:
        return out
    if w is None:
        return out, num / max((n // batch_size) * epochs, 1)
    return out, num / torch.clamp(den, min=1.0)


def client_delta(params_before, params_after):
    """The paper's gradient matrix G for one training loop."""
    return tuple({k: layer_after[k] - layer_before[k] for k in layer_after}
                 for layer_before, layer_after in zip(params_before,
                                                      params_after))
