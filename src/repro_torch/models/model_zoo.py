"""ArchConfig -> runnable model bundle (port of ``repro.models.model_zoo``).

A bundle packages what the launchers and the federated trainer need:

    init(gen)                       -> (params, logical_axes)
    loss_fn(params, batch)          -> scalar loss
    train_step(params, batch, lr)   -> (loss, new_params)       (pure SGD)
    prefill_step(params, batch)     -> (last_logits, caches)
    decode_step(params, batch)      -> (logits, new_caches)
    input_specs(shape, window)      -> tree of ``meta``-device tensors
    make_cache(batch, cache_len)    -> concrete zero caches

Params, batches and caches are the reference's trees of tensors on the
bundle's device (``build(..., device=None)`` is cuda; the CPU only when
asked).  Token ids and positions are int32, as in the reference.  The
serving steps run without autograd.  A model with cross-attention reads
its context from the batch (``context_input``): whisper's frame
embeddings (``audio_embeds``, through the encoder) or a vision model's
patch embeddings (``image_embeds``, as given: the frontends are stubs);
prefill returns the context as ``ctx_tokens`` beside the caches and
decode reads it from there.

``build(cfg, shard=make_shard_fn(mesh))`` runs the bundle on a ``(data,
model)`` mesh: params are DTensors (``sharding.rules.distribute_params``),
each step places the plain tensors of its batch and caches on the mesh
(``place_inputs``) and runs under DTensor's implicit replication (a
plain tensor the model makes, a RoPE frequency or an index, joins a
DTensor as replicated); what it returns is DTensors.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import DTYPES
from repro_torch.models.layers import ModelCtx, no_shard
from repro_torch.params import tree_leaves, tree_map, tree_unflatten


@dataclass(eq=False)
class ModelBundle:
    cfg: ArchConfig
    ctx: ModelCtx
    device: torch.device
    init: Callable
    loss_fn: Callable
    train_step: Callable
    prefill_step: Callable
    decode_step: Callable
    input_specs: Callable
    make_cache: Callable


def _cache_len(cfg: ArchConfig, shape: ShapeConfig, window: int) -> int:
    return min(shape.seq_len, window) if window else shape.seq_len


def context_input(cfg: ArchConfig) -> Optional[Tuple[str, int]]:
    """(batch key, tokens) of the context a config's cross-attention
    reads, each token ``d_model`` wide: whisper's frame embeddings, a
    vision model's patch embeddings; None for a text-only config."""
    if cfg.encoder_layers:
        return "audio_embeds", cfg.encoder_seq
    if cfg.frontend == "vision":
        return "image_embeds", cfg.num_patch_tokens
    return None


def _aux_from_batch(params, cfg: ArchConfig, batch, ctx):
    """Cross-attention context tokens: the encoder's output (audio) or the
    patch embeddings as given (vision); None for a text-only config."""
    context = context_input(cfg)
    if context is None:
        return None
    embeds = batch[context[0]]
    return T.encode(params, cfg, embeds, ctx) if cfg.encoder_layers \
        else embeds


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's implicit replication, restored to what it was on exit
    (``torch.distributed.tensor.experimental.implicit_replication`` turns
    it off, which breaks a step that nests another: a loss inside a
    gradient)."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def on_mesh(params):
    """The context a step over ``params`` runs in: DTensor's implicit
    replication when they are DTensors, else nothing."""
    if not _is_dtensor(next(iter(tree_leaves(params)))):
        return contextlib.nullcontext()
    return _implicit_replication()


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the grads a tree like
    ``params`` (each leaf's gradient in its dtype); params are left as
    they are (no ``requires_grad`` on them).  DTensor params get their
    gradients in their own placements (a partial sum over the batch's
    split reduced), and the loss as a plain replicated tensor."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad(), on_mesh(params):
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        for i, (p, g) in enumerate(zip(leaves, grads)):
            if _is_dtensor(g) and g.placements != p.placements:
                grads[i] = g.redistribute(p.device_mesh, p.placements)
    loss = loss.detach()
    if _is_dtensor(loss):
        loss = loss.full_tensor()
    return loss, tree_unflatten(params, grads)


def sgd_leaf(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """``(p - lr * g)`` in fp32, cast back to p's dtype."""
    return (p.to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype)


def sgd_update(params, grads, lr: float):
    """``sgd_leaf`` over every leaf."""
    return tree_map(lambda p, g: sgd_leaf(p, g, lr), params, grads)


def build(cfg: ArchConfig, shard: Optional[Callable] = None,
          q_chunk: int = 512, remat: bool = True, kv_quant: bool = False,
          moe_dshard: bool = False, moe_groups: int = 1,
          device=None) -> ModelBundle:
    """``shard`` is ``sharding.rules.make_shard_fn(mesh)``'s callback (the
    identity by default: one device); ``moe_groups`` > 1 routes MoE
    tokens in that many groups, as the reference; ``moe_dshard`` places
    the reference's d_model-split MoE dispatch and combine."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    ctx = ModelCtx(cfg=cfg, dtype=dtype, q_chunk=q_chunk, kv_quant=kv_quant,
                   moe_dshard=moe_dshard, moe_groups=moe_groups,
                   shard=shard or no_shard)
    mesh = getattr(shard, "mesh", None)

    def placed(step):
        """``step`` with its batch placed on the mesh, under implicit
        replication (the step itself where there is no mesh)."""
        if mesh is None:
            return step

        @functools.wraps(step)
        def run(params, batch, *args, **kw):
            from repro_torch.sharding.rules import place_inputs
            with on_mesh(params):
                return step(params, place_inputs(batch, mesh), *args, **kw)
        return run

    def init(gen: Union[int, torch.Generator]):
        """(params, axes) drawn from ``gen``: a generator on the bundle's
        device, or an int seed for one."""
        if isinstance(gen, int):
            gen = torch.Generator(device=dev).manual_seed(gen)
        return T.init_model(cfg, gen)

    # ------------------------------------------------------------- train
    @placed
    def loss_fn(params, batch, window: int = 0):
        aux = _aux_from_batch(params, cfg, batch, ctx)
        h, _ = T.forward_hidden(params, cfg, batch["tokens"], ctx, aux=aux,
                                remat=remat,
                                window=window or cfg.sliding_window)
        return T.chunked_ce_loss(params, cfg, h, batch["targets"], ctx)

    def train_step(params, batch, lr: float = 1e-3):
        loss, grads = value_and_grad(loss_fn, params, batch)
        return loss, sgd_update(params, grads, lr)

    # ----------------------------------------------------------- serving
    @placed
    @torch.no_grad()
    def prefill_step(params, batch, window: int = 0):
        """Writes the whole prompt into fresh caches; returns last logits
        (and the context tokens, for decode to read)."""
        aux = _aux_from_batch(params, cfg, batch, ctx)
        h, new_caches = T.forward_hidden(params, cfg, batch["tokens"], ctx,
                                         aux=aux, caches=batch["caches"],
                                         remat=False,
                                         window=window or cfg.sliding_window)
        logits = T.logits_from_hidden(params, cfg, h[:, -1:, :])[:, 0]
        out = {"layers": new_caches}
        if aux is not None:
            out["ctx_tokens"] = aux
        return logits, out

    @placed
    @torch.no_grad()
    def decode_step(params, batch, window: int = 0):
        """One token (B,1) at absolute position pos (B,1) against caches."""
        caches = batch["caches"]
        aux = caches.get("ctx_tokens")
        h, new_caches = T.forward_hidden(
            params, cfg, batch["token"], ctx, positions=batch["pos"],
            aux=aux, caches=caches["layers"], remat=False,
            window=window or cfg.sliding_window)
        logits = T.logits_from_hidden(params, cfg, h[:, 0, :])
        out = {"layers": new_caches}
        if aux is not None:
            out["ctx_tokens"] = aux
        return logits, out

    # -------------------------------------------------------- cache tree
    context = context_input(cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def _self_cache(spec: T.LayerSpec, batch: int, cache_len: int, mk):
        if spec.kind != "attn":           # the SSM state and conv window
            return {"mamba": {
                "h": mk((batch, cfg.num_ssm_heads, cfg.ssm_state,
                         cfg.ssm_head_dim), torch.float32),
                "conv": mk((batch, cfg.ssm_conv_width - 1,
                            cfg.d_inner + 2 * cfg.ssm_state), dtype)}}
        if cfg.use_mla:                   # the latent cache, int8 or not
            return {"attn": {
                "ckv": mk((batch, cache_len, cfg.kv_lora_rank), dtype),
                "krope": mk((batch, cache_len, cfg.qk_rope_dim), dtype),
                "kpos": mk((batch, cache_len), torch.int32)}}
        kv_dtype = torch.int8 if kv_quant else dtype
        c = {"k": mk((batch, cache_len, KV, hd), kv_dtype),
             "v": mk((batch, cache_len, KV, hd), kv_dtype),
             "kpos": mk((batch, cache_len), torch.int32)}
        if kv_quant:
            c["k_scale"] = mk((batch, cache_len, KV), torch.float32)
            c["v_scale"] = mk((batch, cache_len, KV), torch.float32)
        return {"attn": c}

    def _layer_cache(spec: T.LayerSpec, batch: int, cache_len: int, mk):
        c = _self_cache(spec, batch, cache_len, mk)
        if spec.cross:
            # the context's K/V, written once at prefill; in the model
            # dtype under kv_quant too, as the reference's
            t_ctx = context[1]
            c["cross"] = {"k": mk((batch, t_ctx, KV, hd), dtype),
                          "v": mk((batch, t_ctx, KV, hd), dtype),
                          "kpos": mk((batch, t_ctx), torch.int32)}
        return c

    def cache_tree(batch: int, cache_len: int, on: torch.device):
        """Zero caches (``kpos`` -1: every slot empty), the unit's stacked
        on its repeats; on the meta device, shapes only."""
        prefix, unit, repeats = T.unit_pattern(cfg)

        def mk(lead):
            def make(shape, dt):
                if on.type == "meta":
                    return torch.empty(lead + shape, dtype=dt, device=on)
                return torch.full(lead + shape, -1 if dt == torch.int32
                                  else 0, dtype=dt, device=on)
            return make

        out: Dict[str, Any] = {}
        if prefix:
            out["prefix"] = [_layer_cache(s, batch, cache_len, mk(()))
                             for s in prefix]
        out["stack"] = {f"l{i}": _layer_cache(s, batch, cache_len,
                                              mk((repeats,)))
                        for i, s in enumerate(unit)}
        return out

    def make_cache(batch: int, cache_len: int):
        return cache_tree(batch, cache_len, dev)

    # ------------------------------------------------------- input specs
    def input_specs(shape: ShapeConfig, window: int = 0):
        B, S = shape.global_batch, shape.seq_len
        meta = torch.device("meta")

        def ids(*s):
            return torch.empty(s, dtype=torch.int32, device=meta)

        embeds = {} if context is None else {context[0]: torch.empty(
            (B, context[1], cfg.d_model), dtype=dtype, device=meta)}
        if shape.kind == "train":
            return {"tokens": ids(B, S), "targets": ids(B, S), **embeds}
        caches = cache_tree(B, _cache_len(cfg, shape, window), meta)
        if shape.kind == "prefill":
            return {"tokens": ids(B, S), "caches": caches, **embeds}
        caches = {"layers": caches}
        if context is not None:
            caches["ctx_tokens"] = embeds[context[0]]
        return {"token": ids(B, 1), "pos": ids(B, 1), "caches": caches}

    return ModelBundle(cfg=cfg, ctx=ctx, device=dev, init=init,
                       loss_fn=loss_fn, train_step=train_step,
                       prefill_step=prefill_step, decode_step=decode_step,
                       input_specs=input_specs, make_cache=make_cache)
