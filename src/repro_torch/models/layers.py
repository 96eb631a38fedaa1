"""Core transformer layers, dense part: norms, RoPE, GQA self- and
cross-attention, MLPs (port of ``repro.models.layers``).

Conventions, as in the reference:
* every ``*_init`` returns ``(params, axes)`` (see models/common.py);
* every ``*_apply`` takes ``(params, x, ctx, ...)`` and returns either
  ``y`` or ``(y, new_cache)``;
* attention is *query-chunked* when ``Sq > q_chunk`` and ``Sq`` is a
  multiple of it, so a long prefill keeps its score block bounded;
* decode caches are ring buffers ``{"k","v","kpos"}`` — ``kpos`` holds the
  absolute position per slot (−1 = empty), which makes full-cache,
  sliding-window and prefix-filled caches all mask uniformly.

All softmax/norm math runs in fp32; activations stay in the model dtype.

``ctx.shard(x, logical_axes)`` marks the reference's shard points: the
identity on one device, and on a ``(data, model)`` mesh the callback of
``sharding.rules.make_shard_fn``, which redistributes a DTensor
activation (keys, values and caches on ``kv_seq``, the MLP's
``mlp_act``).  Over DTensors, attention runs head parallel on each
rank's local block (``_attention_shards``), so the scores' point places
nothing there; a ring-cache write writes each rank's own slots of the
ring (``_ring_write_shards``).
The attention is the reference's arithmetic (fp32 scores, ``NEG_INF`` on
masked slots, probabilities cast to ``v``'s dtype before the second
product), not ``scaled_dot_product_attention``, whose numerics differ.
MLA (DeepSeek-V2) attends in the compressed (kv-lora) space, its cache
the latent ``{"ckv","krope","kpos"}`` ring buffer; where the config sets
them, its query is low-rank (``q_lora_rank``), its latent RMS-normalised
before ``kv_up`` and the cache (``mla_kv_norm``), and its rotary parts
YaRN-scaled (``yarn_*``, ``Yarn``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.models.common import (dense_init, from_block, merge,
                                       norm_init, replicated, reshape)
from repro_torch.obs.trace import span

NEG_INF = -1e30


def no_shard(x, logical):
    """``ctx.shard`` on one device: places nothing."""
    return x


@dataclass
class ModelCtx:
    cfg: ArchConfig
    dtype: torch.dtype
    q_chunk: int = 512                           # attention query chunk
    kv_quant: bool = False                       # int8 KV cache
    # the reference's d_model-sharded MoE dispatch and combine: it only
    # places shards, so on one device it changes nothing
    moe_dshard: bool = False
    moe_groups: int = 1                          # grouped routing; 1 = global
    shard: Callable = no_shard                   # x, logical axes -> x


# ---------------------------------------------------------------------------
# int8 KV-cache quantization: k/v as int8 + a per-(token, head) fp32 scale
# ---------------------------------------------------------------------------

def quantize_kv(x):
    """x (B,S,KV,hd) -> (int8 values, (B,S,KV) scales)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), axis=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    # torch.round, as jnp.round, rounds half to even
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype):
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_apply(p, x):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, axis=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm_apply(p, x):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, axis=-1, keepdim=True)
    var = torch.var(xf, axis=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def norm_apply(p, x, kind: str):
    return rmsnorm_apply(p, x) if kind == "rmsnorm" else layernorm_apply(p, x)


# ---------------------------------------------------------------------------
# Rotary embeddings (full / partial-dim "2d" / none)
# ---------------------------------------------------------------------------

def _inv_freq(half: int, theta: float, device) -> torch.Tensor:
    """theta ** (-i / half) in fp32.  ``theta`` stays a Python number (a
    kernel argument): a tensor made from it on the device would be a
    host-to-device copy, which waits for the device's queue."""
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(theta, exps)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1·mscale·ln(factor) + 1`` (1 where the
    factor does not stretch)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


@dataclass(frozen=True)
class Yarn:
    """YaRN's rope scaling (arXiv:2309.00071, as DeepSeek-V2's
    ``rope_scaling``): the inverse frequencies of dims that turn fewer
    than ``beta_slow`` times over ``original`` positions are divided by
    ``factor``, those that turn more than ``beta_fast`` times kept, and a
    linear ramp blends the band between; cos and sin are scaled by
    ``yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim)``."""

    factor: float
    original: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float

    @staticmethod
    def of(cfg: ArchConfig) -> Optional["Yarn"]:
        if cfg.yarn_factor <= 1.0:
            return None
        return Yarn(cfg.yarn_factor, cfg.yarn_original_len,
                    cfg.yarn_beta_fast, cfg.yarn_beta_slow, cfg.yarn_mscale,
                    cfg.yarn_mscale_all_dim)

    def band(self, dim: int, theta: float):
        """(low, high): the ramp's ends, in pair indices."""
        def at(turns):
            return dim * math.log(self.original / (turns * 2 * math.pi)) / (
                2 * math.log(theta))
        return (max(math.floor(at(self.beta_fast)), 0),
                min(math.ceil(at(self.beta_slow)), dim - 1))

    def inv_freq(self, half: int, theta: float, device) -> torch.Tensor:
        extra = _inv_freq(half, theta, device)
        inter = extra / self.factor
        low, high = self.band(2 * half, theta)
        if low == high:
            high += 0.001
        ramp = torch.clamp((torch.arange(half, dtype=torch.float32,
                                         device=device) - low) / (high - low),
                           0.0, 1.0)
        return inter * ramp + extra * (1.0 - ramp)

    @property
    def cos_scale(self) -> float:
        return yarn_mscale(self.factor, self.mscale) / yarn_mscale(
            self.factor, self.mscale_all_dim)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0, yarn: Optional[Yarn] = None) -> torch.Tensor:
    """Apply RoPE to x (..., S, H, hd) with positions (..., S).

    The rotation pairs dim i with dim i + rot/2 (half split, not
    interleaved).  fraction < 1 rotates only the first ``fraction*hd``
    dims (ChatGLM's 2d RoPE); theta == 0 disables RoPE entirely (whisper);
    ``yarn`` gives YaRN's frequencies and cos/sin scale.
    """
    if theta == 0.0:
        return x
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = _inv_freq(half, theta, x.device) if yarn is None else \
        yarn.inv_freq(half, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freq      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    if yarn is not None and yarn.cos_scale != 1.0:
        cos, sin = cos * yarn.cos_scale, sin * yarn.cos_scale
    x1 = xr[..., :half].to(torch.float32)
    x2 = xr[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)
    return torch.cat([out.to(x.dtype), xp], axis=-1)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal absolute position embedding (whisper-style stub)."""
    half = dim // 2
    freq = _inv_freq(half, 10000.0, positions.device)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], axis=-1)


# ---------------------------------------------------------------------------
# Attention core — query-chunked, fp32 softmax, window/causal masks
# ---------------------------------------------------------------------------

def _attend(q, k, v, kpos, qpos, ctx: ModelCtx, causal: bool, window: int):
    """q (B,Sq,KV,G,hd); k,v (B,T,KV,hd); kpos (B,T) abs position or -1.

    Returns (B,Sq,KV,G,hd).  Scores shard on the T axis (``kv_seq``).
    """
    hd = q.shape[-1]
    scale = hd ** -0.5
    s = torch.einsum("bqkgh,btkh->bkgqt", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = ctx.shard(s, ("batch", "none", "none", "none", "kv_seq"))
    valid = kpos[:, None, None, None, :] >= 0
    if causal:
        rel = qpos[:, None, None, :, None] - kpos[:, None, None, None, :]
        valid = valid & (rel >= 0)
        if window:
            valid = valid & (rel < window)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, axis=-1)
    return torch.einsum("bkgqt,btkh->bqkgh", p.to(v.dtype), v)


def attention_core(q, k, v, kpos, qpos, ctx: ModelCtx,
                   causal: bool = True, window: int = 0):
    """Query-chunked attention.  q (B,Sq,H,hd) grouped to KV heads.

    A query longer than ``ctx.q_chunk`` (and a multiple of it) runs one
    chunk at a time against the whole of k/v, so the score block is
    (chunk x T) — the reference's scan over chunks.
    """
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _attention_shards(q, k, v, kpos, qpos, ctx, causal, window)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    chunk = ctx.q_chunk
    if Sq <= chunk or Sq % chunk:
        o = _attend(qg, k, v, kpos, qpos, ctx, causal, window)
        return o.reshape(B, Sq, H, hd)
    outs = [_attend(qg[:, i:i + chunk], k, v, kpos, qpos[:, i:i + chunk],
                    ctx, causal, window) for i in range(0, Sq, chunk)]
    return torch.cat(outs, axis=1).reshape(B, Sq, H, hd)


def _rows(mesh, batch: int) -> dict:
    """{"data": 0} where ``data`` splits the batch, else {}."""
    n = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("data", 1)
    return {"data": 0} if n > 1 and batch % n == 0 else {}


def _split_dims(mesh, batch: int, heads: int, head_dim: int) -> dict:
    """{mesh axis: tensor dim it splits} of an attention's operands: the
    batch over ``data`` and the heads over ``model``, each where it
    divides."""
    out = _rows(mesh, batch)
    m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    if m > 1 and heads % m == 0:
        out["model"] = head_dim
    return out


def _placed(t, mesh, split: dict):
    """``t`` (a DTensor, or a tensor the same on every rank) re-laid so
    that each mesh axis in ``split`` splits the tensor dim it names (the
    others replicate)."""
    from torch.distributed.tensor import Replicate, Shard
    return replicated(t, mesh).redistribute(mesh, [
        Shard(split[a]) if a in split else Replicate()
        for a in mesh.mesh_dim_names])


def _block(t, mesh, split: dict, partial=()):
    """``_placed(t, mesh, split)``'s local block and placements.  The
    block's gradient is a partial sum over the axes ``partial`` (where
    the ranks of an axis use a replicated input for their own part)."""
    from torch.distributed.tensor import Partial
    t = _placed(t, mesh, split)
    place = list(t.placements)
    grads = [Partial() if a in partial else q
             for a, q in zip(mesh.mesh_dim_names, place)]
    return t.to_local(grad_placements=grads), place


def _attention_shards(q, k, v, kpos, qpos, ctx: ModelCtx, causal: bool,
                      window: int):
    """``attention_core`` over DTensors, head parallel: each rank attends
    with its batch rows (split over ``data``) and its whole KV head
    groups (over ``model``, where the KV heads divide) on its local
    blocks, with the one-device arithmetic; the keys' ``kv_seq`` split
    of the shard points gathers into it.  DTensor's own einsum would
    flatten a split head axis into a batched product's batch, which
    DTensor refuses without a re-layout in its backward.  Where the KV
    heads do not divide ``model``, sequence parallel instead
    (``_attention_seq_shards``)."""
    mesh = q.device_mesh
    split = _split_dims(mesh, q.shape[0], k.shape[2], 2)
    m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    if m > 1 and "model" not in split and k.shape[1] % m == 0:
        return _attention_seq_shards(q, k, v, kpos, qpos, ctx, causal,
                                     window)
    rows = _rows(mesh, q.shape[0])
    ql, place = _block(q, mesh, split)
    kl, _ = _block(k, mesh, split)
    vl, _ = _block(v, mesh, split)
    o = attention_core(ql, kl, vl, _block(kpos, mesh, rows)[0],
                       _block(qpos, mesh, rows)[0], ctx, causal, window)
    return from_block(o, mesh, place, q.shape)


def _attention_seq_shards(q, k, v, kpos, qpos, ctx: ModelCtx, causal: bool,
                          window: int):
    """``attention_core`` over DTensors whose KV heads do not divide
    ``model``: sequence parallel over the keys' ``kv_seq`` split, as
    GSPMD partitions the reference's scores.  Each rank scores the
    queries of its batch rows (every head) against its own slots of the
    keys in fp32 and keeps its rows' max, the sum of their exponentials
    and the values weighted by them; one all-reduce of the max over
    ``model`` (a constant of the softmax, outside the gradient), then one
    of the sums and of the weighted values (partial sums), give the
    softmax of each whole row.  Nothing of the keys, values or cache
    crosses; the result is the one-device arithmetic up to the order of
    its sums, with the values' product in fp32."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial
    mesh = q.device_mesh
    rows = _rows(mesh, q.shape[0])
    seq = dict(rows, model=1)
    ql, place = _block(q, mesh, rows, partial=("model",))
    kl, _ = _block(k, mesh, seq)
    vl, _ = _block(v, mesh, seq)
    kp, _ = _block(kpos, mesh, seq)
    qp, _ = _block(qpos, mesh, rows)
    group = mesh.get_group("model")
    parts = [Partial() if a == "model" else p
             for a, p in zip(mesh.mesh_dim_names, place)]
    B, Sq, H, hd = ql.shape
    KV = kl.shape[2]
    qg = ql.reshape(B, Sq, KV, H // KV, hd)
    chunk = ctx.q_chunk
    spans = [(0, Sq)] if Sq <= chunk or Sq % chunk else \
        [(i, i + chunk) for i in range(0, Sq, chunk)]

    def whole(t, shape):
        return from_block(t, mesh, parts, shape).redistribute(
            mesh, place).to_local()
    outs = []
    for a, b in spans:
        s = torch.einsum("bqkgh,btkh->bkgqt", qg[:, a:b].to(torch.float32),
                         kl.to(torch.float32)) * hd ** -0.5
        valid = kp[:, None, None, None, :] >= 0
        if causal:
            rel = qp[:, None, None, a:b, None] - kp[:, None, None, None, :]
            valid = valid & (rel >= 0)
            if window:
                valid = valid & (rel < window)
        s = s.masked_fill(~valid, NEG_INF)
        top = funcol.all_reduce(s.amax(-1, keepdim=True).detach(), "max",
                                group)
        e = torch.exp(s - top)
        num = torch.einsum("bkgqt,btkh->bqkgh", e, vl.to(torch.float32))
        den = e.sum(-1).permute(0, 3, 1, 2)[..., None]
        num = whole(num, (q.shape[0],) + num.shape[1:])
        den = whole(den, (q.shape[0],) + den.shape[1:])
        outs.append((num / den).to(v.dtype))
    o = torch.cat(outs, axis=1).reshape(B, Sq, H, hd)
    return from_block(o, mesh, place, q.shape)


# ---------------------------------------------------------------------------
# GQA self-attention (with optional cross-attention mode)
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg: ArchConfig, dtype):
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return merge(
        ("q", dense_init(gen, D, H * hd, "embed,heads", dtype, cfg.qkv_bias)),
        ("k", dense_init(gen, D, KV * hd, "embed,kv", dtype, cfg.qkv_bias)),
        ("v", dense_init(gen, D, KV * hd, "embed,kv", dtype, cfg.qkv_bias)),
        ("o", dense_init(gen, H * hd, D, "heads,embed", dtype)),
    )


def _dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def gqa_apply(p, x, ctx: ModelCtx, positions, *, kv_x=None, kv_positions=None,
              cache=None, causal=True, window: int = 0):
    """Self- or cross-attention.

    cache: {"k": (B,T,KV,hd), "v": ..., "kpos": (B,T)} ring buffer; when
    given, x is the new token block written at ``positions``.
    Returns (y, new_cache) (new_cache None for cache-less calls).
    """
    cfg = ctx.cfg
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q = reshape(_dense(p["q"], x), B, S, H, hd)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    q = ctx.shard(q, ("batch", "none", "none", "none"))

    if cache is not None and kv_x is not None and S == 1:
        # cross-attention DECODE: reuse the K/V computed at prefill
        k, v, kpos = cache["k"], cache["v"], cache["kpos"]
        o = attention_core(q, k, v, kpos, positions, ctx, causal=False,
                           window=0)
        new_cache = cache
    elif cache is None or kv_x is not None:
        Skv = src.shape[1]
        kpos = (torch.arange(Skv, dtype=torch.int32,
                             device=x.device)[None].expand(B, Skv)
                if kv_positions is None else kv_positions)
        k = reshape(_dense(p["k"], src), B, Skv, KV, hd)
        v = reshape(_dense(p["v"], src), B, Skv, KV, hd)
        if kv_x is None:                      # self-attention gets RoPE
            k = rope(k, kpos, cfg.rope_theta, cfg.rope_fraction)
        k = ctx.shard(k, ("batch", "kv_seq", "none", "none"))
        v = ctx.shard(v, ("batch", "kv_seq", "none", "none"))
        o = attention_core(q, k, v, kpos, positions, ctx, causal, window)
        # cross-attention PREFILL with a cache: store K/V for decode
        new_cache = ({"k": k.to(cache["k"].dtype),
                      "v": v.to(cache["v"].dtype), "kpos": kpos}
                     if (cache is not None and kv_x is not None) else None)
    else:
        k_new = reshape(_dense(p["k"], src), B, S, KV, hd)
        v_new = reshape(_dense(p["v"], src), B, S, KV, hd)
        k_new = rope(k_new, positions, cfg.rope_theta, cfg.rope_fraction)
        T = cache["k"].shape[1]
        slot = positions % T                                  # ring buffer
        if ctx.kv_quant:
            kq, ks = quantize_kv(k_new)
            vq, vs = quantize_kv(v_new)
            kc = _ring_write(cache["k"], kq, slot)
            vc = _ring_write(cache["v"], vq, slot)
            ksc = _ring_write(cache["k_scale"], ks, slot)
            vsc = _ring_write(cache["v_scale"], vs, slot)
            kpos = _ring_write(cache["kpos"], positions, slot)
            kc = ctx.shard(kc, ("batch", "kv_seq", "none", "none"))
            vc = ctx.shard(vc, ("batch", "kv_seq", "none", "none"))
            k = dequantize_kv(kc, ksc, x.dtype)
            v = dequantize_kv(vc, vsc, x.dtype)
            new_cache = {"k": kc, "v": vc, "k_scale": ksc,
                         "v_scale": vsc, "kpos": kpos}
        else:
            k = _ring_write(cache["k"], k_new, slot)
            v = _ring_write(cache["v"], v_new, slot)
            kpos = _ring_write(cache["kpos"], positions, slot)
            k = ctx.shard(k, ("batch", "kv_seq", "none", "none"))
            v = ctx.shard(v, ("batch", "kv_seq", "none", "none"))
            new_cache = {"k": k, "v": v, "kpos": kpos}
        o = attention_core(q, k, v, kpos, positions, ctx, causal, window)

    y = _dense(p["o"], reshape(o, B, S, H * hd))
    return y, new_cache


def _ring_write(buf, new, slot):
    """Write new (B,S,...) into a copy of buf (B,T,...) at per-token slots
    (B,S)."""
    from torch.distributed.tensor import DTensor
    if isinstance(buf, DTensor):
        return _ring_write_shards(buf, new, slot)
    B, S = slot.shape
    bidx = torch.arange(B, device=buf.device)[:, None].expand(B, S)
    out = buf.clone()
    out[bidx, slot.to(torch.int64)] = new.to(buf.dtype)
    return out


def _ring_write_shards(buf, new, slot):
    """``_ring_write`` of a DTensor ring: each rank writes the tokens whose
    slot falls in its own slots ``[lo, lo + T_l)`` of the ring (and its
    own batch rows), the others into a scratch slot cut off after, so
    nothing crosses but ``new`` and ``slot`` gathered to the ring's
    batch split."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, place = buf.device_mesh, buf.placements
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in place]

    def local(t):
        return replicated(t, mesh).redistribute(mesh, rows).to_local()
    b, n, sl = buf.to_local(), local(new), local(slot)
    _, offset = compute_local_shape_and_global_offset(buf.shape, mesh, place)
    t_l = b.shape[1]
    s = sl.to(torch.int64) - offset[1]
    s = torch.where((s >= 0) & (s < t_l), s, torch.full_like(s, t_l))
    out = torch.cat([b, b[:, :1]], axis=1)
    bidx = torch.arange(b.shape[0], device=b.device)[:, None].expand_as(s)
    out[bidx, s] = n.to(b.dtype)
    return from_block(out[:, :t_l], mesh, place, buf.shape)


def attn_cache_init(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                    device):
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, cache_len, KV, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, KV, hd), dtype=dtype,
                         device=device),
        "kpos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2), absorbed decode path
# ---------------------------------------------------------------------------

def _lora_norm(dim: int, dtype, device):
    """An RMSNorm's scale over a lora axis (replicated on a mesh)."""
    p, _ = norm_init(dim, dtype, device=device)
    return p, {"scale": "lora"}


def mla_init(gen, cfg: ArchConfig, dtype):
    """The query (one dense ``q``, or with ``q_lora_rank`` the low-rank
    ``q_a`` → RMSNorm ``q_norm`` → ``q_b``), the latent's ``kv_down`` (and
    its RMSNorm ``kv_norm`` with ``mla_kv_norm``), ``kv_up`` and ``o``."""
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
    dev = torch.device("meta") if gen is None else gen.device
    if cfg.q_lora_rank:
        ql = cfg.q_lora_rank
        query = [("q_a", dense_init(gen, D, ql, "embed,lora", dtype)),
                 ("q_norm", _lora_norm(ql, dtype, dev)),
                 ("q_b", dense_init(gen, ql, H * (hd + rd), "lora,heads",
                                    dtype))]
    else:
        # per-head query: nope part (hd) + rope part (rd)
        query = [("q", dense_init(gen, D, H * (hd + rd), "embed,heads",
                                  dtype))]
    # compressed kv (lora) + shared rope key
    kv = [("kv_down", dense_init(gen, D, r + rd, "embed,lora", dtype))]
    if cfg.mla_kv_norm:
        kv.append(("kv_norm", _lora_norm(r, dtype, dev)))
    return merge(
        *query, *kv,
        # decompress: k_nope (hd) + v (hd) per head
        ("kv_up", dense_init(gen, r, H * 2 * hd, "lora,heads", dtype)),
        ("o", dense_init(gen, H * hd, D, "heads,embed", dtype)),
    )


def mla_scale(cfg: ArchConfig) -> float:
    """The softmax scale: (hd + rd)^-1/2, times YaRN's
    ``yarn_mscale(factor, mscale_all_dim)`` squared where it is set."""
    scale = (cfg.head_dim + cfg.qk_rope_dim) ** -0.5
    if cfg.yarn_factor > 1.0 and cfg.yarn_mscale_all_dim:
        m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
        scale = scale * m * m
    return scale


def mla_cache_init(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                   device):
    return {
        "ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                             dtype=dtype, device=device),
        "kpos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                           device=device),
    }


def _query(p, x):
    """The queries before the head split: ``q(x)``, or with q-lora
    ``q_b(RMSNorm(q_a(x)))``."""
    if "q" in p:
        return _dense(p["q"], x)
    return _dense(p["q_b"], rmsnorm_apply(p["q_norm"], _dense(p["q_a"], x)))


def _mla_qkv(p, x, ctx: ModelCtx, positions):
    """(q_nope, q_rope, ckv, krope); ``ckv`` the (normalised, with
    ``kv_norm``) latent that ``kv_up`` decompresses and the cache holds."""
    cfg = ctx.cfg
    B, S, _ = x.shape
    H, hd, rd, r = cfg.num_heads, cfg.head_dim, cfg.qk_rope_dim, \
        cfg.kv_lora_rank
    yarn = Yarn.of(cfg)
    q = reshape(_query(p, x), B, S, H, hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = rope(q_rope, positions, cfg.rope_theta, yarn=yarn)
    down = _dense(p["kv_down"], x)                       # (B,S,r+rd)
    ckv, krope = down[..., :r], down[..., r:]
    if "kv_norm" in p:
        ckv = rmsnorm_apply(p["kv_norm"], ckv)
    krope = rope(krope[:, :, None, :], positions, cfg.rope_theta,
                 yarn=yarn)[:, :, 0]
    return q_nope, q_rope, ckv, krope


def _mla_attend(q_nope, q_rope, ckv, krope, kpos, qpos, p, ctx: ModelCtx):
    """Absorbed MLA attention: scores in compressed (lora) space, fp32.

    q_nope (B,S,H,hd), q_rope (B,S,H,rd); ckv (B,T,r), krope (B,T,rd).
    Over DTensors, head parallel as ``_attention_shards``: a rank takes
    its batch rows and heads of the queries and of ``kv_up``, and the
    whole latent sequence of its rows.  A query of one position a row
    (decode) against slots that split over ``model`` runs sequence
    parallel instead (``_mla_attend_seq_shards``).
    """
    from torch.distributed.tensor import DTensor
    if isinstance(q_nope, DTensor):
        mesh = q_nope.device_mesh
        split = _split_dims(mesh, q_nope.shape[0], q_nope.shape[2], 2)
        m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
        if m > 1 and q_nope.shape[1] == 1 and ckv.shape[1] % m == 0:
            q_nope, q_rope = (_placed(q, mesh, split)
                              for q in (q_nope, q_rope))
            return _mla_attend_seq_shards(q_nope, q_rope, ckv, krope, kpos,
                                          qpos, p, ctx)
        rows = {a: d for a, d in split.items() if a == "data"}
        heads = ("model",) if "model" in split else ()
        qn, place = _block(q_nope, mesh, split)
        qr, _ = _block(q_rope, mesh, split)
        up = {"w": _block(p["kv_up"]["w"], mesh, {
            a: 1 for a in split if a == "model"}, partial=tuple(rows))[0]}
        o = _mla_attend(qn, qr, _block(ckv, mesh, rows, heads)[0],
                        _block(krope, mesh, rows, heads)[0],
                        _block(kpos, mesh, rows)[0],
                        _block(qpos, mesh, rows)[0], {"kv_up": up}, ctx)
        return from_block(o, mesh, place, q_nope.shape)
    cfg = ctx.cfg
    B, S, H, hd = q_nope.shape
    r = cfg.kv_lora_rank
    wu = p["kv_up"]["w"].reshape(r, H, 2 * hd)
    wk = wu[..., :hd].to(torch.float32)                  # (r,H,hd)
    wv = wu[..., hd:].to(torch.float32)                  # (r,H,hd)
    ckv_f = ckv.to(torch.float32)
    # absorb k-decompression into q:  q' = q_nope · wkᵀ  -> (B,S,H,r)
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope.to(torch.float32), wk)
    scale = mla_scale(cfg)
    s = (torch.einsum("bshr,btr->bhst", q_abs, ckv_f) +
         torch.einsum("bshd,btd->bhst", q_rope.to(torch.float32),
                      krope.to(torch.float32))) * scale
    s = ctx.shard(s, ("batch", "none", "none", "kv_seq"))
    valid = (kpos[:, None, None, :] >= 0) & \
        (qpos[:, None, :, None] >= kpos[:, None, None, :])
    s = s.masked_fill(~valid, NEG_INF)
    pr = torch.softmax(s, axis=-1)
    # attend in compressed space, then decompress through wv
    o_c = torch.einsum("bhst,btr->bshr", pr, ckv_f)
    o = torch.einsum("bshr,rhd->bshd", o_c, wv)
    return o.to(ckv.dtype)


def _mla_attend_seq_shards(q_nope, q_rope, ckv, krope, kpos, qpos, p,
                           ctx: ModelCtx):
    """``_mla_attend`` over DTensors at decode, sequence parallel on the
    latent cache's ``kv_seq`` split over ``model``, as GSPMD partitions
    the reference's scores.  Each rank absorbs ``wk`` into the queries of
    its heads (its slice of ``kv_up``) and gathers ``q_abs`` (B,1,H,r)
    and ``q_rope`` over ``model``; scores every head against its own
    slots of ``ckv`` and ``krope`` in fp32; all-reduces the rows' max (a
    constant of the softmax, outside the gradient) and then the sums of
    their exponentials; forms ``o_c`` as a partial sum over its slots and
    reduce-scatters it over the heads, so that it holds the whole
    ``o_c`` of its own heads, which its ``wv`` decompresses.  Nothing of
    ``ckv``, ``krope`` or ``kpos`` crosses a rank; the result is the
    one-device arithmetic up to the order of its sums.  The queries come
    in split by rows over ``data`` and by heads over ``model`` (where
    they divide), as ``_mla_attend`` places them.

    Why at decode only.  A rank sends (m-1)/m of 2·H·r·4 B a row (the
    fp32 ``q_abs`` gathered and ``o_c`` reduced; ``q_rope`` and the two
    (B,H) reductions add H·rd·2 B and less), where gathering the row's
    cache sends (m-1)/m of T·(r + rd)·2 B: with deepseek-v2's H = 128,
    r = 512 and rd = 64, 2·128·512·4 B = 524,288 B against 1,152 B a
    slot, so the gather costs more once the cache holds more than ≈ 455
    slots (≈ 470 with ``q_rope``).  A longer query turns the other way:
    a 512-query chunk of prefill reduces 512·H·r·4 B ≈ 134 MB a row,
    while the row's whole 32,768-slot cache is gathered once, 37.7 MB,
    for every chunk; so prefill and the cache-less step stay head
    parallel."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial
    cfg = ctx.cfg
    mesh = q_nope.device_mesh
    B, S, H, hd = q_nope.shape
    r = cfg.kv_lora_rank
    split = _split_dims(mesh, B, H, 2)
    rows = _rows(mesh, B)
    seq = dict(rows, model=1)
    qn, place = _block(q_nope, mesh, split)
    up = _block(p["kv_up"]["w"], mesh, {a: 1 for a in split if a == "model"},
                partial=tuple(rows))[0]
    wu = up.reshape(r, qn.shape[2], 2 * hd)
    wk = wu[..., :hd].to(torch.float32)                  # (r,H_l,hd)
    wv = wu[..., hd:].to(torch.float32)
    q_abs = torch.einsum("bshd,rhd->bshr", qn.to(torch.float32), wk)

    def all_heads(t):
        """A block of this rank's heads as the block of every head."""
        return _block(from_block(t, mesh, place, (B, S, H, t.shape[-1])),
                      mesh, rows)
    q_abs = all_heads(q_abs)[0]                          # (B_l,1,H,r)
    qr, row_place = all_heads(_block(q_rope, mesh, split)[0])
    cl, _ = _block(ckv, mesh, seq)
    kr, _ = _block(krope, mesh, seq)
    kp, _ = _block(kpos, mesh, seq)
    qp, _ = _block(qpos, mesh, rows)
    group = mesh.get_group("model")
    ckv_f = cl.to(torch.float32)
    scale = mla_scale(cfg)
    s = (torch.einsum("bshr,btr->bhst", q_abs, ckv_f) +
         torch.einsum("bshd,btd->bhst", qr.to(torch.float32),
                      kr.to(torch.float32))) * scale
    valid = (kp[:, None, None, :] >= 0) & \
        (qp[:, None, :, None] >= kp[:, None, None, :])
    s = s.masked_fill(~valid, NEG_INF)
    top = funcol.all_reduce(s.amax(-1, keepdim=True).detach(), "max", group)
    e = torch.exp(s - top)
    parts = [Partial() if a == "model" else q
             for a, q in zip(mesh.mesh_dim_names, row_place)]
    den = e.sum(-1, keepdim=True)                        # (B_l,H,1,1)
    den = from_block(den, mesh, parts, (B,) + den.shape[1:]).redistribute(
        mesh, row_place).to_local()
    num = torch.einsum("bhst,btr->bshr", e / den, ckv_f)  # over my slots
    o_c = from_block(num, mesh, parts, (B, S, H, r)).redistribute(
        mesh, place).to_local()                          # (B_l,1,H_l,r)
    o = torch.einsum("bshr,rhd->bshd", o_c, wv)
    return from_block(o.to(ckv.dtype), mesh, place, q_nope.shape)


def mla_apply(p, x, ctx: ModelCtx, positions, *, cache=None):
    """MLA self-attention; returns (y, new_cache) (None without a cache).

    A cache-less query longer than ``ctx.q_chunk`` (and a multiple of it)
    attends one chunk at a time against the whole latent sequence, each
    chunk under ``torch.utils.checkpoint`` while autograd records (the
    reference's ``jax.checkpoint`` over its scan of chunks).  The whole
    layer is the span ``mla``; under remat it opens again in the
    backward's recompute."""
    with span("mla"):
        return _mla_apply(p, x, ctx, positions, cache)


def _mla_apply(p, x, ctx: ModelCtx, positions, cache):
    cfg = ctx.cfg
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q_nope, q_rope, ckv, krope = _mla_qkv(p, x, ctx, positions)
    if cache is None:
        kpos = torch.arange(S, device=x.device)[None].expand(B, S)
        chunk = ctx.q_chunk
        if S > chunk and S % chunk == 0:
            def attend(qn, qr, qp):
                return _mla_attend(qn, qr, ckv, krope, kpos, qp, p, ctx)

            outs = []
            for i in range(0, S, chunk):
                qn, qr = q_nope[:, i:i + chunk], q_rope[:, i:i + chunk]
                qp = positions[:, i:i + chunk]
                outs.append(checkpoint(attend, qn, qr, qp,
                                       use_reentrant=False)
                            if torch.is_grad_enabled()
                            else attend(qn, qr, qp))
            o = torch.cat(outs, axis=1)
        else:
            o = _mla_attend(q_nope, q_rope, ckv, krope, kpos, positions, p,
                            ctx)
        new_cache = None
    else:
        T = cache["ckv"].shape[1]
        slot = positions % T
        ckv_c = _ring_write(cache["ckv"], ckv, slot)
        krope_c = _ring_write(cache["krope"], krope, slot)
        kpos = _ring_write(cache["kpos"], positions, slot)
        ckv_c = ctx.shard(ckv_c, ("batch", "kv_seq", "none"))
        o = _mla_attend(q_nope, q_rope, ckv_c, krope_c, kpos, positions, p,
                        ctx)
        new_cache = {"ckv": ckv_c, "krope": krope_c, "kpos": kpos}
    y = _dense(p["o"], reshape(o, B, S, H * hd))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ArchConfig, dtype, d_ff: Optional[int] = None):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.activation != "gelu":                     # gated
        return merge(
            ("wi", dense_init(gen, D, Fd, "embed,mlp", dtype)),
            ("wg", dense_init(gen, D, Fd, "embed,mlp", dtype)),
            ("wo", dense_init(gen, Fd, D, "mlp,embed", dtype)),
        )
    return merge(
        ("wi", dense_init(gen, D, Fd, "embed,mlp", dtype, bias=True)),
        ("wo", dense_init(gen, Fd, D, "mlp,embed", dtype, bias=True)),
    )


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x, ctx: ModelCtx):
    """``act(wi·x) * (wg·x)`` when gated (the activation is on ``wi``),
    else ``act(wi·x)``; then ``wo``.  The span ``mlp`` (a dense layer's
    MLP or an MoE layer's shared experts); under remat it opens again in
    the backward's recompute."""
    act = F.silu if ctx.cfg.activation != "gelu" else _gelu
    with span("mlp"):
        h = _dense(p["wi"], x)
        if "wg" in p:
            h = act(h) * _dense(p["wg"], x)
        else:
            h = act(h)
        h = ctx.shard(h, ("batch", "none", "mlp_act"))
        return _dense(p["wo"], h)
