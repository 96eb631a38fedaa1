"""Plain reference of SCBF's federated step on DeepSeek-V2 as published
(https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json,
arXiv:2405.04434), in fp32 with TF32 off, at the widths it is given.

Written from the published description, not from the program:

* multi-head latent attention with a low-rank query: ``q_a`` (d_model →
  q_lora), an RMSNorm, ``q_b`` (q_lora → heads × (128 + 64)); the keys'
  and values' latent ``kv_down`` (d_model → 512 + 64), the 512-wide part
  RMS-normalised (``kv_a_layernorm``) and decompressed by ``kv_up`` to a
  128-wide key part and a 128-wide value a head, the 64-wide rotary key
  shared by the heads; scores over the whole 192-wide query and key;
* YaRN rope scaling (arXiv:2309.00071, DeepSeek-V2's ``rope_scaling``):
  inverse frequencies theta^(-2i/d) kept for the dims that turn more than
  ``beta_fast`` times over the original length, divided by ``factor`` for
  those that turn fewer than ``beta_slow`` times, a linear ramp between;
  cos and sin times mscale(factor, mscale) / mscale(factor,
  mscale_all_dim), and the softmax scale 192^-1/2 times mscale(factor,
  mscale_all_dim)^2, where mscale(s, m) = 0.1·m·ln(s) + 1;
* the leading dense layers a SwiGLU MLP of their own width (12,288);
* the MoE layers: a softmax router in fp32 over all routed experts;
  group-limited greedy top-k (the experts in ``groups`` consecutive
  groups, each scored by its largest probability, the ``top_groups``
  best kept, the rest masked to 0, the top-k taken from what is left);
  gates the kept probabilities, renormalised to sum to 1 only with
  ``norm_topk``, times ``scale`` (16); the layer holds experts
  ``[offset, offset + held)`` of them and computes only their part, each
  taking at most ``capacity`` tokens in token order (capacity from the
  published expert count), plus the shared SwiGLU experts;
* RMSNorm eps 1e-6 everywhere; the final norm, the head and the mean
  cross-entropy of the next tokens;
* the step: ``bench/reference/lm.py``'s (each client's gradient, its
  channels scored by squared norms, the (1 - rate)-quantile threshold,
  the kept channels summed and ``W - lr·Σ`` stored as bf16), client by
  client, the first client's kept channels compact while the second's
  gradient exists.

Departures from the published model, each shared with the program:
RoPE rotates half-split pairs (i, i + d/2) where the published code
rotates interleaved ones (on random weights a fixed permutation of the
rotary weight columns); a token past an expert's capacity is dropped in
token order at factor 1.25 (DeepSeek-V2's training drops per device by
lowest affinity at factor 1.0); the loss has none of DeepSeek-V2's three
balance losses; the experts held elsewhere add nothing (their chips are
absent).  ``precision="fp8"`` (the control) rounds every matrix
product's operands as ``lm.py`` does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

from reference.lm import (NEG, StepRecord, _columns, capacity, kept_columns,
                          matmul, rmsnorm, swiglu)


@dataclass(frozen=True)
class Dims:
    d_model: int
    heads: int
    head_dim: int
    rope_dim: int
    kv_lora: int
    q_lora: int
    experts: int             # the router's width (the published count)
    top_k: int
    capacity_factor: float
    groups: int
    top_groups: int
    norm_topk: bool
    scale: float
    held: int
    offset: int
    yarn_factor: float
    yarn_original: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float
    rope_theta: float = 10000.0
    eps: float = 1e-6

    @staticmethod
    def of(a) -> "Dims":
        """From an object with ``repro_torch.config.ArchConfig``'s field
        names (read as plain attributes)."""
        return Dims(d_model=a.d_model, heads=a.num_heads,
                    head_dim=a.head_dim, rope_dim=a.qk_rope_dim,
                    kv_lora=a.kv_lora_rank, q_lora=a.q_lora_rank,
                    experts=a.num_experts, top_k=a.experts_per_token,
                    capacity_factor=a.moe_capacity_factor,
                    groups=a.router_expert_groups,
                    top_groups=a.router_topk_groups,
                    norm_topk=a.router_norm_topk, scale=a.router_scale,
                    held=a.experts_held or a.num_experts,
                    offset=a.experts_offset, yarn_factor=a.yarn_factor,
                    yarn_original=a.yarn_original_len,
                    beta_fast=a.yarn_beta_fast, beta_slow=a.yarn_beta_slow,
                    mscale=a.yarn_mscale,
                    mscale_all_dim=a.yarn_mscale_all_dim,
                    rope_theta=a.rope_theta)


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1.0 else 0.1 * m * math.log(factor) + 1.0


def correction_dim(turns: float, dim: int, theta: float, original: int
                   ) -> float:
    """The rotary dim whose frequency turns ``turns`` times over
    ``original`` positions."""
    return dim * math.log(original / (turns * 2 * math.pi)) / (
        2 * math.log(theta))


def inv_freq(dims: Dims, device) -> torch.Tensor:
    d = dims.rope_dim
    base = dims.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=device) / d)
    extra = 1.0 / base
    if dims.yarn_factor <= 1.0:
        return extra
    inter = 1.0 / (dims.yarn_factor * base)
    low = max(math.floor(correction_dim(dims.beta_fast, d, dims.rope_theta,
                                        dims.yarn_original)), 0)
    high = min(math.ceil(correction_dim(dims.beta_slow, d, dims.rope_theta,
                                        dims.yarn_original)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0.0, 1.0)
    extrapolate = 1.0 - ramp
    return inter * (1.0 - extrapolate) + extra * extrapolate


def rope(x, positions, dims: Dims):
    """x (..., S, H, d) rotated pairwise (i, i + d/2) by position, YaRN's
    frequencies and cos/sin scale."""
    half = x.shape[-1] // 2
    ang = positions[:, None].to(torch.float32) * inv_freq(dims, x.device)
    m = mscale(dims.yarn_factor, dims.mscale) / mscale(
        dims.yarn_factor, dims.mscale_all_dim)
    cos = (torch.cos(ang) * m)[:, None, :]
    sin = (torch.sin(ang) * m)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def softmax_scale(dims: Dims) -> float:
    s = (dims.head_dim + dims.rope_dim) ** -0.5
    if dims.yarn_factor > 1.0 and dims.mscale_all_dim:
        m = mscale(dims.yarn_factor, dims.mscale_all_dim)
        s = s * m * m
    return s


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def mla(x, p, pre, dims: Dims, mm):
    B, S, D = x.shape
    H, hd, rd, r = dims.heads, dims.head_dim, dims.rope_dim, dims.kv_lora
    pos = torch.arange(S, device=x.device)
    if pre + "attn.q_a.w" in p:
        cq = rmsnorm(mm(x, p[pre + "attn.q_a.w"]), p[pre + "attn.q_norm.scale"],
                     dims.eps)
        q = mm(cq, p[pre + "attn.q_b.w"])
    else:
        q = mm(x, p[pre + "attn.q.w"])
    qh = q.view(B, S, H, hd + rd)
    q_nope, q_rope = qh[..., :hd], rope(qh[..., hd:], pos, dims)
    down = mm(x, p[pre + "attn.kv_down.w"])
    ckv = down[..., :r]
    if pre + "attn.kv_norm.scale" in p:
        ckv = rmsnorm(ckv, p[pre + "attn.kv_norm.scale"], dims.eps)
    krope = rope(down[..., r:][:, :, None, :], pos, dims)
    kv = mm(ckv, p[pre + "attn.kv_up.w"]).view(B, S, H, 2 * hd)
    k_nope, v = kv[..., :hd], kv[..., hd:]
    k = torch.cat([k_nope, krope.expand(B, S, H, rd)], -1)
    qq = torch.cat([q_nope, q_rope], -1)
    s = mm(qq.transpose(1, 2), k.permute(0, 2, 3, 1))       # (B,H,S,S)
    s = s * softmax_scale(dims)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, NEG)
    o = mm(torch.softmax(s, -1), v.transpose(1, 2))          # (B,H,S,hd)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return mm(o, p[pre + "attn.o.w"])


def route(probs, dims: Dims):
    """(gate, expert) (T, k): group-limited greedy top-k and its gates."""
    T, E = probs.shape
    scores = probs
    if dims.groups > 1:
        per = probs.view(T, dims.groups, E // dims.groups)
        best = torch.topk(per.max(-1).values, dims.top_groups, -1).indices
        mask = torch.zeros(T, dims.groups, dtype=torch.bool,
                           device=probs.device)
        mask[torch.arange(T, device=probs.device)[:, None], best] = True
        scores = torch.where(mask[:, :, None], per, 0.0).view(T, E)
    gate, expert = torch.topk(scores, dims.top_k, -1)
    if dims.norm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate * dims.scale, expert


def moe(x, p, pre, dims: Dims, mm):
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    T, k = xt.shape[0], dims.top_k
    probs = torch.softmax(mm(xt, p[pre + "moe.router.w"]), -1)
    gate, expert = route(probs, dims)
    cap = capacity(dims, T)
    flat_e = expert.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    flat_g = gate.reshape(-1)
    out = torch.zeros_like(xt)
    wi, wg, wo = (p[pre + f"moe.{n}"] for n in ("wi", "wg", "wo"))
    for e in range(dims.offset, dims.offset + dims.held):
        rows = torch.nonzero(flat_e == e).reshape(-1)[:cap]
        if rows.numel() == 0:
            continue
        toks = flat_t[rows]
        h = e - dims.offset
        y = swiglu(xt[toks], wi[h], wg[h], wo[h], mm)
        out = out.index_add(0, toks, y * flat_g[rows][:, None])
    shared = swiglu(xt, p[pre + "moe.shared.wi.w"], p[pre + "moe.shared.wg.w"],
                    p[pre + "moe.shared.wo.w"], mm)
    return (out + shared).view(B, S, D)


def block(x, p, pre, dims: Dims, mm):
    h = x + mla(rmsnorm(x, p[pre + "norm1.scale"], dims.eps), p, pre, dims,
                mm)
    z = rmsnorm(h, p[pre + "norm2.scale"], dims.eps)
    if pre + "moe.router.w" in p:
        return h + moe(z, p, pre, dims, mm)
    return h + swiglu(z, p[pre + "mlp.wi.w"], p[pre + "mlp.wg.w"],
                      p[pre + "mlp.wo.w"], mm)


def loss(p: Dict[str, torch.Tensor], tokens, targets, layers: Sequence,
         dims: Dims, mm) -> torch.Tensor:
    """Mean next-token cross-entropy of one client's batch; ``layers`` as
    in ``lm.loss``: (leaf-name prefix, index in its stack or None)."""
    x = p["embed.w"][tokens.long()]
    for pre, index in layers:
        lp = {n: (v if index is None else v[index]) for n, v in p.items()
              if n.startswith(pre)}
        x = block(x, lp, pre, dims, mm)
    x = rmsnorm(x, p["final_norm.scale"], dims.eps)
    logits = mm(x, p["unembed.w"])
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (lse - gold).mean()


# ---------------------------------------------------------------------------
# the federated step
# ---------------------------------------------------------------------------

def fed_step(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             layers: Sequence, dims: Dims, rate: float, lr: float,
             stored: Dict[str, torch.dtype], precision: str = "fp32"
             ) -> StepRecord:
    """One federated step of the clients of ``batch`` ((K, B, S) tokens
    and targets) on ``p`` (fp32 leaves, updated in place and rounded to
    each leaf's stored dtype)."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _fed_step(p, batch, layers, dims, rate, lr, stored,
                         matmul(precision))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def _fed_step(p, batch, layers, dims, rate, lr, stored, mm) -> StepRecord:
    names = list(p)
    leaves = [p[n].requires_grad_(True) for n in names]
    compact: List[Dict] = []
    losses: List[float] = []
    norms: Dict[str, float] = {}
    clients = batch["tokens"].shape[0]
    for c in range(clients):
        with torch.enable_grad():
            lval = loss(p, batch["tokens"][c], batch["targets"][c], layers,
                        dims, mm)
            grads = torch.autograd.grad(lval, leaves)
        losses.append(float(lval.detach()))
        g = dict(zip(names, grads))
        del grads, lval
        for n in names:
            norms[n] = norms.get(n, 0.0) + float(torch.linalg.vector_norm(g[n]))
        keep = kept_columns(g, rate)
        if c < clients - 1:
            part = {}
            for n in names:
                if keep[n] is None:
                    part[n] = (None, g[n])
                else:
                    idx = torch.nonzero(keep[n]).reshape(-1)
                    part[n] = (idx, _columns(g[n])[:, idx])
                g[n] = None
            compact.append(part)
            del g
            continue
        with torch.no_grad():
            for n in names:
                total = g[n]
                if keep[n] is not None:
                    total = torch.where(keep[n], _columns(total), 0.0) \
                        .view_as(total)
                for part in compact:
                    idx, vals = part[n]
                    if idx is None:
                        total = total + vals
                    else:
                        _columns(total).index_add_(1, idx, vals)
                    part[n] = None
                g[n] = None
                leaf = p[n]
                leaf.sub_(lr * total)
                leaf.copy_(leaf.to(stored[n]))
                del total
        del g, compact
    for n in names:
        p[n].requires_grad_(False)
    return StepRecord(loss=sum(losses) / clients, grad_norms=norms)

