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
serving steps run without autograd.  ``build`` refuses what the port
does not run yet — the encoder, modality frontends and cross-attention —
with ``NotImplementedError`` naming ROADMAP A14b.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Union

import torch

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import DTYPES
from repro_torch.models.layers import ModelCtx
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


def refuse_unported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP A14b for a config
    that needs a module this slice does not port."""
    for needs, what in ((cfg.encoder_layers, "the encoder (encoder_layers)"),
                        (cfg.frontend != "none",
                         f"the {cfg.frontend} frontend"),
                        (cfg.cross_attn_every,
                         "cross-attention (cross_attn_every)")):
        if needs:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}) needs {what}: {T.A14B}")


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the grads a tree like
    ``params`` (each leaf's gradient in its dtype); params are left as
    they are (no ``requires_grad`` on them)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def sgd_leaf(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """``(p - lr * g)`` in fp32, cast back to p's dtype."""
    return (p.to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype)


def sgd_update(params, grads, lr: float):
    """``sgd_leaf`` over every leaf."""
    return tree_map(lambda p, g: sgd_leaf(p, g, lr), params, grads)


def build(cfg: ArchConfig, q_chunk: int = 512, remat: bool = True,
          kv_quant: bool = False, moe_dshard: bool = False,
          moe_groups: int = 1, device=None) -> ModelBundle:
    """``moe_groups`` > 1 routes MoE tokens in that many groups, as the
    reference; ``moe_dshard`` places the reference's shards and changes
    nothing on one device."""
    refuse_unported(cfg)
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    ctx = ModelCtx(cfg=cfg, dtype=dtype, q_chunk=q_chunk, kv_quant=kv_quant,
                   moe_dshard=moe_dshard, moe_groups=moe_groups)

    def init(gen: Union[int, torch.Generator]):
        """(params, axes) drawn from ``gen``: a generator on the bundle's
        device, or an int seed for one."""
        if isinstance(gen, int):
            gen = torch.Generator(device=dev).manual_seed(gen)
        return T.init_model(cfg, gen)

    # ------------------------------------------------------------- train
    def loss_fn(params, batch, window: int = 0):
        h, _ = T.forward_hidden(params, cfg, batch["tokens"], ctx,
                                remat=remat,
                                window=window or cfg.sliding_window)
        return T.chunked_ce_loss(params, cfg, h, batch["targets"], ctx)

    def train_step(params, batch, lr: float = 1e-3):
        loss, grads = value_and_grad(loss_fn, params, batch)
        return loss, sgd_update(params, grads, lr)

    # ----------------------------------------------------------- serving
    @torch.no_grad()
    def prefill_step(params, batch, window: int = 0):
        """Writes the whole prompt into fresh caches; returns last logits."""
        h, new_caches = T.forward_hidden(params, cfg, batch["tokens"], ctx,
                                         caches=batch["caches"], remat=False,
                                         window=window or cfg.sliding_window)
        logits = T.logits_from_hidden(params, cfg, h[:, -1:, :])[:, 0]
        return logits, {"layers": new_caches}

    @torch.no_grad()
    def decode_step(params, batch, window: int = 0):
        """One token (B,1) at absolute position pos (B,1) against caches."""
        h, new_caches = T.forward_hidden(
            params, cfg, batch["token"], ctx, positions=batch["pos"],
            caches=batch["caches"]["layers"], remat=False,
            window=window or cfg.sliding_window)
        logits = T.logits_from_hidden(params, cfg, h[:, 0, :])
        return logits, {"layers": new_caches}

    # -------------------------------------------------------- cache tree
    def _layer_cache(spec: T.LayerSpec, batch: int, cache_len: int, mk):
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
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        kv_dtype = torch.int8 if kv_quant else dtype
        c = {"k": mk((batch, cache_len, KV, hd), kv_dtype),
             "v": mk((batch, cache_len, KV, hd), kv_dtype),
             "kpos": mk((batch, cache_len), torch.int32)}
        if kv_quant:
            c["k_scale"] = mk((batch, cache_len, KV), torch.float32)
            c["v_scale"] = mk((batch, cache_len, KV), torch.float32)
        return {"attn": c}

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

        if shape.kind == "train":
            return {"tokens": ids(B, S), "targets": ids(B, S)}
        caches = cache_tree(B, _cache_len(cfg, shape, window), meta)
        if shape.kind == "prefill":
            return {"tokens": ids(B, S), "caches": caches}
        return {"token": ids(B, 1), "pos": ids(B, 1),
                "caches": {"layers": caches}}

    return ModelBundle(cfg=cfg, ctx=ctx, device=dev, init=init,
                       loss_fn=loss_fn, train_step=train_step,
                       prefill_step=prefill_step, decode_step=decode_step,
                       input_specs=input_specs, make_cache=make_cache)
