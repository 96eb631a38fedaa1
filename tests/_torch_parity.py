"""Shared helpers for the torch-port parity tests: carrying values between
numpy, JAX and torch, and re-deriving the reference's random draws so
the port can be fed exactly what the reference consumed.

JAX's threefry stream and torch's generators cannot share numbers, so
every ported function that draws takes its draws as an optional input;
these helpers produce the reference's.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.core.scbf import _derive_round_keys
from repro.models.mlp_net import init_mlp


def np_tree(tree):
    """Layer dicts of JAX or torch arrays → layer dicts of numpy arrays."""
    out = []
    for layer in tree:
        d = {}
        for k, v in layer.items():
            if v is None:
                d[k] = None
            elif isinstance(v, torch.Tensor):
                d[k] = v.detach().cpu().numpy()
            else:
                d[k] = np.asarray(v)
        out.append(d)
    return tuple(out)


def epoch_perms(key, n: int, epochs: int):
    """The permutations ``repro.core.client.local_train_impl`` draws from
    ``key`` (one per epoch, full length; the trainer cuts the tail)."""
    keys = jax.random.split(key, epochs)
    return [np.asarray(jax.random.permutation(k, n)) for k in keys]


def reference_draws(seed: int, feats, shard_sizes, loops: int, epochs: int):
    """(init params as numpy, perms(loop, client, epoch)) of a reference
    ``run_federated`` at full participation.

    Follows the driver's key stream: one split for the init key, then
    ``_derive_round_keys`` per round with training keys indexed by
    client id.
    """
    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)
    init = np_tree(init_mlp(feats, init_key))
    k = len(shard_sizes)
    part = np.arange(k)
    table = {}
    for loop in range(loops):
        key, ckeys, _, _ = _derive_round_keys(key, k, part, k)
        for c in part:
            for e, perm in enumerate(epoch_perms(ckeys[c], shard_sizes[c],
                                                 epochs)):
                table[(loop, int(c), e)] = perm
    return init, lambda loop, client, epoch: table[(loop, client, epoch)]
