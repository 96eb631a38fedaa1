"""Generic decoder(-encoder) transformer over a repeating layer pattern
(port of ``repro.models.transformer``).

Every architecture is expressed as:

    prefix layers (unrolled)  +  R repeats of a layer *unit*

(the prefix's dense MLPs ``dense_d_ff`` wide where the config sets it)

where a unit is the architecture's repeating pattern — 1 layer for dense
models, Mamba2 and DeepSeek-V2 (after its dense prefix layer), [dense,
moe] for Llama-4, 8 layers (7 Mamba, 1 attention) for Jamba, [4 x self,
self + cross] for the VLM.  Unit
params are stacked on a leading "layers" axis, as in the reference, so
the param tree (and the leaves SCBF scores and masks: a
per-layer bias ``(N,)`` is a 2-D ``(R, N)`` leaf) is the reference's.  The
reference's ``lax.scan`` over the repeats is a Python loop over ``R``
over the stacked params and caches, each leaf split once into its units
(``_unstack``, DTensor params too); ``remat`` runs each unit
under ``torch.utils.checkpoint`` (the backward recomputes the unit's
activations), which changes no result.

Caches mirror the param structure: a tree per unit, stacked on the same
leading axis.  A cross-attention sublayer attends to context tokens
(``aux``): whisper's encoder output (``encode``, over the stub's frame
embeddings) or a vision model's patch embeddings, its K/V computed once
at prefill and kept in the layer's ``cross`` cache.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.common import (DTYPES, dense_init, device_of,
                                       from_block, merge, norm_init,
                                       replicated, stack_inits, trunc_normal)
from repro_torch.models.layers import ModelCtx
from repro_torch.params import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class LayerSpec:
    kind: str            # "attn" | "mamba"
    moe: bool = False
    cross: bool = False  # extra cross-attention sublayer


def layer_specs(cfg: ArchConfig) -> List[LayerSpec]:
    specs = []
    for l in range(cfg.num_layers):
        kind = "attn" if cfg._is_attn_layer(l) else "mamba"
        cross = bool(cfg.cross_attn_every) and \
            (l % cfg.cross_attn_every == cfg.cross_attn_every - 1)
        specs.append(LayerSpec(kind, cfg._is_moe_layer(l), cross))
    return specs


def unit_pattern(cfg: ArchConfig) -> Tuple[List[LayerSpec], List[LayerSpec], int]:
    """(prefix_specs, unit_specs, repeats)."""
    specs = layer_specs(cfg)
    prefix = specs[:cfg.first_dense_layers]
    rest = specs[cfg.first_dense_layers:]
    period = 1
    for k in (cfg.attention_every, cfg.moe_every if cfg.num_experts else 1,
              cfg.cross_attn_every or 1):
        period = math.lcm(period, k)
    if len(rest) % period:
        raise ValueError(f"{cfg.name}: {len(rest)} layers not divisible by "
                         f"pattern period {period}")
    unit = rest[:period]
    for r in range(0, len(rest), period):
        if rest[r:r + period] != unit:
            raise ValueError(f"{cfg.name}: layer pattern is not periodic")
    return prefix, unit, len(rest) // period


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ArchConfig, spec: LayerSpec, dtype,
                d_ff: int = 0):
    """One layer's params; ``d_ff`` the width of its dense MLP (0: the
    config's ``d_ff``)."""
    dev = device_of(gen)
    ln = cfg.norm == "layernorm"
    pairs = [("norm1", norm_init(cfg.d_model, dtype, bias=ln, device=dev))]
    if spec.kind == "attn":
        attn = L.mla_init(gen, cfg, dtype) if cfg.use_mla \
            else L.gqa_init(gen, cfg, dtype)
        pairs.append(("attn", attn))
    else:
        pairs.append(("mamba", M.mamba_init(gen, cfg, dtype)))
    if spec.cross:
        pairs.append(("cross_norm", norm_init(cfg.d_model, dtype, bias=ln,
                                              device=dev)))
        pairs.append(("cross", L.gqa_init(gen, cfg, dtype)))
    if cfg.d_ff:
        pairs.append(("norm2", norm_init(cfg.d_model, dtype, bias=ln,
                                         device=dev)))
        pairs.append(("moe", MOE.moe_init(gen, cfg, dtype)) if spec.moe
                     else ("mlp", L.mlp_init(gen, cfg, dtype, d_ff=d_ff)))
    return merge(*pairs)


def _unit_init(gen, cfg: ArchConfig, unit: List[LayerSpec], dtype):
    return merge(*[(f"l{i}", _layer_init(gen, cfg, s, dtype))
                   for i, s in enumerate(unit)])


def _encoder_layer_init(gen, cfg: ArchConfig, dtype):
    dev = device_of(gen)
    ln = cfg.norm == "layernorm"
    return merge(
        ("norm1", norm_init(cfg.d_model, dtype, bias=ln, device=dev)),
        ("attn", L.gqa_init(gen, cfg, dtype)),
        ("norm2", norm_init(cfg.d_model, dtype, bias=ln, device=dev)),
        ("mlp", L.mlp_init(gen, cfg, dtype)),
    )


def init_model(cfg: ArchConfig, gen: Optional[torch.Generator]
               ) -> Tuple[Dict, Dict]:
    """Returns (params, logical_axes) for the full model, drawn from
    ``gen`` on its device (``gen=None``: on the meta device)."""
    dtype = DTYPES[cfg.dtype]
    prefix, unit, repeats = unit_pattern(cfg)
    dev = device_of(gen)

    params: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}
    scale = 1.0 / math.sqrt(cfg.d_model)
    params["embed"] = {"w": trunc_normal(gen, (cfg.vocab_size, cfg.d_model),
                                         scale, dtype)}
    axes["embed"] = {"w": "vocab,embed"}

    if prefix:
        params["prefix"], axes["prefix"] = merge(
            *[(f"p{i}", _layer_init(gen, cfg, s, dtype, cfg.dense_d_ff))
              for i, s in enumerate(prefix)])

    params["stack"], axes["stack"] = stack_inits(
        lambda g: _unit_init(g, cfg, unit, dtype), gen, repeats)

    params["final_norm"], axes["final_norm"] = norm_init(
        cfg.d_model, dtype, bias=cfg.norm == "layernorm", device=dev)

    if not cfg.tie_embeddings:
        params["unembed"], axes["unembed"] = dense_init(
            gen, cfg.d_model, cfg.vocab_size, "embed,vocab", dtype)

    if cfg.encoder_layers:
        stack_p, stack_a = stack_inits(
            lambda g: _encoder_layer_init(g, cfg, dtype), gen,
            cfg.encoder_layers)
        fn_p, fn_a = norm_init(cfg.d_model, dtype,
                               bias=cfg.norm == "layernorm", device=dev)
        params["encoder"] = {"stack": stack_p, "final_norm": fn_p}
        axes["encoder"] = {"stack": stack_a, "final_norm": fn_a}
    return params, axes


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_forward(lp, spec: LayerSpec, h, ctx: ModelCtx, positions,
                   aux: Optional[torch.Tensor], cache, window: int):
    """One layer; returns (h, new_cache)."""
    cfg = ctx.cfg
    new_cache = {}
    xin = L.norm_apply(lp["norm1"], h, cfg.norm)
    sub = "attn" if spec.kind == "attn" else "mamba"
    sub_cache = None if cache is None else cache.get(sub)
    if spec.kind != "attn":
        a, c = M.mamba_apply(lp["mamba"], xin, ctx, cache=sub_cache)
    elif cfg.use_mla:
        a, c = L.mla_apply(lp["attn"], xin, ctx, positions, cache=sub_cache)
    else:
        a, c = L.gqa_apply(lp["attn"], xin, ctx, positions, cache=sub_cache,
                           causal=True, window=window)
    h = h + a
    if c is not None:
        new_cache[sub] = c
    if spec.cross:
        if aux is None:
            raise ValueError("a cross-attention layer needs context tokens")
        xin = L.norm_apply(lp["cross_norm"], h, cfg.norm)
        a, c = L.gqa_apply(lp["cross"], xin, ctx, positions, kv_x=aux,
                           causal=False,
                           cache=None if cache is None
                           else cache.get("cross"))
        h = h + a
        if c is not None:
            new_cache["cross"] = c
    if "mlp" in lp or "moe" in lp:
        xin = L.norm_apply(lp["norm2"], h, cfg.norm)
        if "moe" in lp:
            h = h + MOE.moe_apply(lp["moe"], xin, ctx)
        else:
            h = h + L.mlp_apply(lp["mlp"], xin, ctx)
    return h, (new_cache or None)


def _unit_forward(unit_p, unit_specs, h, ctx, positions, aux, unit_cache,
                  window):
    new_caches = {}
    for i, spec in enumerate(unit_specs):
        cache_i = None if unit_cache is None else unit_cache[f"l{i}"]
        h, nc = _layer_forward(unit_p[f"l{i}"], spec, h, ctx, positions,
                               aux, cache_i, window)
        new_caches[f"l{i}"] = nc if nc is not None else {}
    return h, new_caches


def forward_hidden(params, cfg: ArchConfig, tokens, ctx: ModelCtx,
                   positions=None, aux=None, caches=None,
                   remat: bool = False, window: int = 0):
    """Token ids -> final hidden states.

    caches: {"prefix": [...], "stack": stacked tree} or None.
    Returns (hidden (B,S,D), new_caches-or-None).
    """
    prefix, unit, repeats = unit_pattern(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    h = _embed(params["embed"]["w"], tokens)
    if cfg.rope_theta == 0.0:             # whisper: sinusoidal abs positions
        h = h + L.sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    h = ctx.shard(h, ("batch", "none", "none"))

    new_caches: Dict[str, Any] = {}
    if prefix:
        pc = []
        for i, spec in enumerate(prefix):
            cache_i = None if caches is None else caches["prefix"][i]
            h, nc = _layer_forward(params["prefix"][f"p{i}"], spec, h, ctx,
                                   positions, aux, cache_i, window)
            pc.append(nc if nc is not None else {})
        new_caches["prefix"] = pc

    def unit_fn(h_, up, uc):
        return _unit_forward(up, tuple(unit), h_, ctx, positions, aux, uc,
                             window)

    # each stacked leaf split once into its R units: one backward (a
    # stack) a leaf, where indexing it R times would make R full-size
    # gradients to add up
    units_p = _unstack(params["stack"], repeats)
    units_c = None if caches is None else _unstack(caches["stack"], repeats)
    outs = []
    for r in range(repeats):
        unit_p = units_p[r]
        unit_c = None if units_c is None else units_c[r]
        if remat and torch.is_grad_enabled():
            h, nc = checkpoint(unit_fn, h, unit_p, unit_c,
                               use_reentrant=False)
        else:
            h, nc = unit_fn(h, unit_p, unit_c)
        outs.append(nc)
    if caches is not None:
        new_caches["stack"] = tree_map(lambda *xs: torch.stack(xs), outs[0],
                                       *outs[1:])

    h = L.norm_apply(params["final_norm"], h, cfg.norm)
    return h, (new_caches if caches is not None else None)


def _embed(w, tokens):
    """The rows of ``w`` (V, D) at ``tokens``.  A DTensor table keeps its
    vocabulary split (over the mesh axes that do not split the token
    rows) and gathers the rest, its FSDP split; each rank looks up the
    ids in its own slice of the vocabulary (0 elsewhere), for its own
    token rows, and the rows sum over the vocabulary's axes (a partial
    sum, of one row and zeros), as GSPMD partitions the reference's
    gather.  DTensor's sharded ``embedding`` loses a vocabulary split's
    mask when the token ids split over another mesh axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if not isinstance(w, DTensor):
        return w[tokens.to(torch.int64)]
    mesh = w.device_mesh
    tokens = replicated(tokens, mesh)
    keep = [isinstance(p, Shard) and p.dim == 0 and not isinstance(r, Shard)
            for p, r in zip(w.placements, tokens.placements)]
    place = [Shard(0) if k else Replicate() for k in keep]
    # a rank's table gradient is its own token rows' part of the sum
    table = w.redistribute(mesh, place).to_local(grad_placements=[
        Shard(0) if k else Partial() if isinstance(r, Shard) else Replicate()
        for k, r in zip(keep, tokens.placements)])
    _, offset = compute_local_shape_and_global_offset(w.shape, mesh, place)
    at = tokens.to_local().to(torch.int64) - offset[0]
    inside = (at >= 0) & (at < table.shape[0])
    rows = torch.where(inside[..., None], table[torch.where(inside, at, 0)],
                       0)
    return from_block(rows, mesh, [Partial() if k else r for k, r in
                                   zip(keep, tokens.placements)],
                      tuple(tokens.shape) + (w.shape[1],))


def _gold(logits, ti):
    """``logits`` (B, S, V) at the ids ``ti`` (B, S).  Over a DTensor whose
    vocabulary is split, each rank picks the ids in its own slice (0
    elsewhere) and the picks sum over the vocabulary's axes (a partial
    sum), as GSPMD partitions the reference's gather."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, ti[..., None])[..., 0]
    mesh, place = logits.device_mesh, logits.placements
    last = logits.ndim - 1
    vocab = [isinstance(p, Shard) and p.dim == last for p in place]
    rows = [Replicate() if v else p for v, p in zip(vocab, place)]
    ti = replicated(ti, mesh)
    ids = ti.redistribute(mesh, rows).to_local()
    local = logits.to_local()
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                      place)
    at = ids - offset[last]
    inside = (at >= 0) & (at < local.shape[-1])
    picked = torch.gather(local, -1, torch.where(inside, at, 0)[..., None])
    picked = torch.where(inside, picked[..., 0], 0.0)
    return from_block(picked, mesh,
                      [Partial() if v else p for v, p in zip(vocab, rows)],
                      ti.shape)


def _unstack(stacked, repeats: int) -> List[Any]:
    """A tree of leaves stacked on a leading R axis -> R trees."""
    parts = [leaf.unbind(0) for leaf in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [p[r] for p in parts])
            for r in range(repeats)]


def _encoder_layer(lp, h, ctx: ModelCtx, positions):
    cfg = ctx.cfg
    xin = L.norm_apply(lp["norm1"], h, cfg.norm)
    a, _ = L.gqa_apply(lp["attn"], xin, ctx, positions, causal=False)
    h = h + a
    xin = L.norm_apply(lp["norm2"], h, cfg.norm)
    return h + L.mlp_apply(lp["mlp"], xin, ctx)


def encode(params, cfg: ArchConfig, embeds, ctx: ModelCtx,
           remat: bool = True):
    """Whisper encoder over precomputed frame embeddings (B,T,D):
    sinusoidal positions, then non-causal attention and the MLP a layer,
    each layer under ``torch.utils.checkpoint`` when ``remat`` and grad
    is enabled (the reference's ``jax.checkpoint`` in its scan)."""
    B, T, D = embeds.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=embeds.device)[None].expand(B, T)
    h = embeds + L.sinusoidal_positions(positions, D).to(embeds.dtype)
    enc = params["encoder"]
    for lp in _unstack(enc["stack"], cfg.encoder_layers):
        if remat and torch.is_grad_enabled():
            h = checkpoint(_encoder_layer, lp, h, ctx, positions,
                           use_reentrant=False)
        else:
            h = _encoder_layer(lp, h, ctx, positions)
    return L.norm_apply(enc["final_norm"], h, cfg.norm)


def _unembed(params, cfg: ArchConfig):
    return params["embed"]["w"].T if cfg.tie_embeddings \
        else params["unembed"]["w"]


def logits_from_hidden(params, cfg: ArchConfig, h):
    return h @ _unembed(params, cfg)


def chunked_ce_loss(params, cfg: ArchConfig, h, targets, ctx: ModelCtx,
                    chunk: int = 512):
    """Cross-entropy over the vocab, one sequence chunk at a time, so the
    (B,S,V) logits tensor never materialises whole."""
    B, S, D = h.shape
    w = _unembed(params, cfg)
    if S % chunk:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        logits = (h[:, i:i + chunk] @ w).to(torch.float32)
        logits = ctx.shard(logits, ("batch", "none", "vocab_act"))
        lse = torch.logsumexp(logits, axis=-1)
        ti = targets[:, i:i + chunk].to(torch.int64)
        gold = _gold(logits, ti)
        total = total + torch.sum(lse - gold)
    return total / (B * S)
