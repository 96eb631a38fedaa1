"""Plain reference of SCBF's federated step on a DeepSeek-V2 block
(arXiv:2405.04434), in fp32 with TF32 off, at the widths it is given.

Written from the architecture and the method, not from the program:

* the model: token embedding; per layer an RMSNorm (eps 1e-6) before
  multi-head latent attention (queries projected per head to a 128-wide
  part and a 64-wide rotary part; keys and values decompressed from a
  512-wide latent, the rotary key shared by the heads; RoPE on the
  rotary parts, half-split, theta 10,000; scores scaled by 192^-1/2,
  causal) and an RMSNorm before the feed-forward: a SwiGLU MLP in the
  dense layer, a mixture of experts in the MoE layer (a softmax router in
  fp32, the top 6 of 160 experts with their gates renormalised to sum to
  1, at most ``capacity`` tokens an expert taken in token order, the
  rest dropped, plus the shared SwiGLU experts); a final RMSNorm, the
  output head, and the mean cross-entropy of the next tokens;
* the step: each client's gradient on its batch; its output channels (the
  last axis of a weight, the others flattened) scored by their squared
  norms in fp32, the threshold the (1 - rate)-quantile of all of a
  client's channel scores (linear interpolation at q·(n-1) in fp32), the
  channels at or above it kept (a 1-D leaf always); the clients' kept
  gradients summed in fp32 and ``W - lr·Σ`` stored as the configuration
  stores weights (bf16).

It runs client by client, keeps the first client's kept channels compact
while the second's gradient exists, and frees each client's gradient
before the next.  ``precision="fp8"`` (the control) rounds every matrix
product's operands to fp8 (e4m3 forward, e5m2 gradients, each tensor
scaled to its largest magnitude) and computes the rest as before.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

NEG = -1e30


@dataclass(frozen=True)
class Dims:
    d_model: int
    heads: int
    head_dim: int
    rope_dim: int
    kv_lora: int
    experts: int
    top_k: int
    capacity_factor: float
    rope_theta: float = 10000.0
    eps: float = 1e-6


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype):
    """``x`` as fp8 of ``dtype`` scaled to its largest magnitude: (the fp8
    tensor, the scale to multiply back)."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30).to(torch.float32)
    return (x.detach() * (top / amax)).clamp(-top, top).to(dtype), amax / top


def _up(q) -> torch.Tensor:
    return q[0].to(torch.float32) * q[1]


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` on operands rounded to fp8 e4m3, the gradient rounded to
    e5m2 before each of its two products; the operands are kept for the
    backward in fp8 (one byte an entry)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.saved = (qa, qb)
        return _up(qa) @ _up(qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved
        ctx.saved = None
        g = _up(_fp8(g, torch.float8_e5m2))
        return g @ _up(qb).transpose(-1, -2), _up(qa).transpose(-1, -2) @ g


def _fp8_matmul(a, b):
    if b.ndim == 2 and a.ndim > 2:
        out = _Fp8Matmul.apply(a.reshape(-1, a.shape[-1]), b)
        return out.view(*a.shape[:-1], b.shape[-1])
    return _Fp8Matmul.apply(a, b)


def matmul(precision: str) -> Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor]:
    """The reference's matrix product: fp32 (TF32 off), or the control's
    fp8."""
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return _fp8_matmul
    raise ValueError(f"precision {precision!r}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x (..., S, H, d) rotated pairwise (i, i + d/2) by position."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freq     # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def swiglu(x, wi, wg, wo, mm):
    return mm(torch.nn.functional.silu(mm(x, wi)) * mm(x, wg), wo)


def mla(x, p, pre, dims: Dims, mm):
    B, S, D = x.shape
    H, hd, rd, r = dims.heads, dims.head_dim, dims.rope_dim, dims.kv_lora
    pos = torch.arange(S, device=x.device)
    qh = mm(x, p[pre + "attn.q.w"]).view(B, S, H, hd + rd)
    q_nope, q_rope = qh[..., :hd], rope(qh[..., hd:], pos, dims.rope_theta)
    down = mm(x, p[pre + "attn.kv_down.w"])
    ckv = down[..., :r]
    krope = rope(down[..., r:][:, :, None, :], pos, dims.rope_theta)
    up = p[pre + "attn.kv_up.w"].view(r, H * 2 * hd)
    kv = mm(ckv, up).view(B, S, H, 2 * hd)
    k_nope, v = kv[..., :hd], kv[..., hd:]
    k = torch.cat([k_nope, krope.expand(B, S, H, rd)], -1)
    qq = torch.cat([q_nope, q_rope], -1)
    s = mm(qq.transpose(1, 2), k.permute(0, 2, 3, 1))       # (B,H,S,S)
    s = s * (hd + rd) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, NEG)
    o = mm(torch.softmax(s, -1), v.transpose(1, 2))          # (B,H,S,hd)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return mm(o, p[pre + "attn.o.w"])


def capacity(dims: Dims, tokens: int) -> int:
    c = max(int(dims.capacity_factor * tokens * dims.top_k / dims.experts), 1)
    return ((c + 7) // 8) * 8


def moe(x, p, pre, dims: Dims, mm):
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    T, E, k = xt.shape[0], dims.experts, dims.top_k
    probs = torch.softmax(mm(xt, p[pre + "moe.router.w"]), -1)
    gate, eidx = torch.topk(probs, k, -1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(dims, T)
    flat_e = eidx.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    flat_g = gate.reshape(-1)
    out = torch.zeros_like(xt)
    wi, wg, wo = (p[pre + f"moe.{n}"] for n in ("wi", "wg", "wo"))
    for e in range(E):
        rows = torch.nonzero(flat_e == e).reshape(-1)[:cap]
        if rows.numel() == 0:
            continue
        toks = flat_t[rows]
        y = swiglu(xt[toks], wi[e], wg[e], wo[e], mm)
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
    """Mean next-token cross-entropy of one client's batch; ``layers`` are
    the blocks in order, each (leaf-name prefix, index): a block's leaves
    are ``p[prefix + name]``, or that leaf's slice ``index`` where the
    blocks of a repeated unit are stacked on a leading axis."""
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

def quantile(values: torch.Tensor, q: float) -> torch.Tensor:
    vals = torch.sort(values).values
    n = vals.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    lo = int(torch.clamp(torch.floor(pos), 0, n - 1))
    hi = int(torch.clamp(torch.ceil(pos), 0, n - 1))
    frac = (pos - torch.floor(pos)).to(vals.device)
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def _columns(g: torch.Tensor) -> torch.Tensor:
    return g.reshape(-1, g.shape[-1])


def kept_columns(grads: Dict[str, torch.Tensor], rate: float
                 ) -> Dict[str, Optional[torch.Tensor]]:
    """{leaf: bool (N,) kept output channels, or None for a 1-D leaf}."""
    scores = {n: (_columns(g) ** 2).sum(0) for n, g in grads.items()
              if g.ndim >= 2}
    thr = quantile(torch.cat(list(scores.values())), 1.0 - rate)
    return {n: (scores[n] >= thr if n in scores else None) for n in grads}


@dataclass
class StepRecord:
    loss: float
    kept_fraction: List[float] = field(default_factory=list)
    grad_norms: Dict[str, float] = field(default_factory=dict)


def fed_step(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             layers: Sequence, dims: Dims, rate: float, lr: float,
             stored: Dict[str, torch.dtype], precision: str = "fp32"
             ) -> StepRecord:
    """One federated step of the clients of ``batch`` ((K, B, S) tokens
    and targets) on ``p`` (fp32 leaves, updated in place and rounded to
    each leaf's stored dtype, ``stored[name]``)."""
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
    losses, fracs, norms = [], [], {}
    clients = batch["tokens"].shape[0]
    for c in range(clients):
        with torch.enable_grad():
            lval = loss(p, batch["tokens"][c], batch["targets"][c], layers,
                        dims, mm)
            grads = torch.autograd.grad(lval, leaves)
        losses.append(float(lval.detach()))
        g = dict(zip(names, grads))
        del grads
        for n in names:
            norms[n] = norms.get(n, 0.0) + float(torch.linalg.vector_norm(g[n]))
        keep = kept_columns(g, rate)
        kept = sum((int(keep[n].sum()) * (g[n].numel() // g[n].shape[-1]))
                   if keep[n] is not None else g[n].numel() for n in names)
        fracs.append(kept / sum(g[n].numel() for n in names))
        if c < clients - 1:
            # this client's kept channels, compact, until the sum
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
                        cols = _columns(total)
                        cols.index_add_(1, idx, vals)
                g[n] = None
                leaf = p[n]
                leaf.sub_(lr * total)
                leaf.copy_(leaf.to(stored[n]))
                del total
        del g, compact
    for n in names:
        p[n].requires_grad_(False)
    return StepRecord(loss=sum(losses) / clients, kept_fraction=fracs,
                      grad_norms=norms)
