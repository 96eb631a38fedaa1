"""Shared helpers for the torch-port parity tests: carrying values between
numpy, JAX and torch, and re-deriving the reference's random draws so
the port can be fed exactly what the reference consumed.

JAX's threefry stream and torch's generators cannot share numbers, so
every ported function that draws takes its draws as an optional input;
these helpers produce the reference's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
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


def reference_normals(key, shapes):
    """The standard normals ``repro.core.privacy.gaussian_mechanism`` draws
    from ``key`` for leaves of ``shapes`` (in the tree's flatten order)."""
    keys = jax.random.split(key, len(shapes))
    return [np.asarray(jax.random.normal(k, tuple(s), jnp.float32))
            for k, s in zip(keys, shapes)]


def reference_draws(seed: int, feats, shard_sizes, loops: int, epochs: int,
                    participants=None):
    """(init params as numpy, perms(loop, client, epoch), dp_noise(loop,
    i, shapes)) of a reference ``run_federated``.

    Follows the driver's key stream: one split for the init key, then
    ``_derive_round_keys`` per round with training keys indexed by
    client id (so the perms do not depend on who takes part) and DP keys
    by position in the round; ``participants(loop)`` gives a round's
    participants (default: every client).  ``shard_sizes[c]`` is the
    length of client c's permutations: its shard, or n_max on the
    reference's batched engine.
    """
    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)
    init = np_tree(init_mlp(feats, init_key))
    k = len(shard_sizes)
    table, dp_keys = {}, {}
    for loop in range(loops):
        part = np.arange(k) if participants is None else \
            np.asarray(participants(loop))
        nxt, ckeys_all, _, _ = _derive_round_keys(key, k, np.arange(k), k)
        _, _, _, dks = _derive_round_keys(key, k, part, part.size)
        key = nxt
        for c in range(k):
            for e, perm in enumerate(epoch_perms(ckeys_all[c],
                                                 shard_sizes[c], epochs)):
                table[(loop, c, e)] = perm
        dp_keys[loop] = dks

    def perms(loop, client, epoch):
        return table[(loop, client, epoch)]

    def dp_noise(loop, i, shapes):
        return reference_normals(dp_keys[loop][i], shapes)

    return init, perms, dp_noise


def reference_config(cfg):
    """The reference's config of a port config: the same dataclass of
    ``repro.config`` field for field (the two packages' configs share
    names and defaults)."""
    import dataclasses

    import repro.config as ref_config
    if not dataclasses.is_dataclass(cfg):
        return cfg
    kind = getattr(ref_config, type(cfg).__name__)
    return kind(**{f.name: reference_config(getattr(cfg, f.name))
                   for f in dataclasses.fields(cfg)})
