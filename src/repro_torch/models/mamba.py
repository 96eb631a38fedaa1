"""Mamba2 / SSD block — chunked matmul form (port of ``repro.models.mamba``).

arXiv:2405.21060: the sequence is split into chunks of ``ssm_chunk``;
within a chunk the SSD quadratic (matmul) form runs as fp32 einsums, and
a Python loop over the chunks carries the (heads, state, head_dim) SSM
state across them (the reference's ``lax.scan``).  Decode is the O(1)
recurrence.

Layout per block (ngroups = 1, as in the 2.7B config):
    in_x  : (D, d_inner)      main path
    in_z  : (D, d_inner)      gate
    in_B  : (D, N)            input->state projection
    in_C  : (D, N)            state->output projection
    in_dt : (D, nh)           per-head timestep
    conv  : (w, d_inner+2N)   depthwise causal conv over [x, B, C]
    A_log : (nh,)             state decay  (A = -exp(A_log))
    D_res : (nh,)             skip
    out   : (d_inner, D)

One choice differs from the reference, in gradients only: the
intra-chunk decay is ``exp(where(tril, cs_q - cs_k, -inf))``, where the
reference takes ``exp(cs_q - cs_k)`` over the whole square and masks the
upper triangle afterwards.  Above the diagonal that exponent is positive
and overflows fp32 once a chunk's decay passes 88.7 (at the published
chunk of 256 and dt near softplus(0)), and the backward then multiplies
0 by inf.  The forward values are the reference's (the lower triangle is
the same ``exp``, the upper one 0 in both), and so are the gradients
wherever the reference's are finite.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models.common import (dense_init, device_of, from_block,
                                       merge, reshape, trunc_normal)
from repro_torch.models.layers import ModelCtx, _block, _rows, _split_dims


def mamba_init(gen, cfg: ArchConfig, dtype):
    """(params, axes) of one block, drawn from ``gen`` (``None``: on the
    meta device); ``A_log`` and ``D_res`` are fp32 whatever ``dtype``."""
    D, DI, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    NH, W = cfg.num_ssm_heads, cfg.ssm_conv_width
    dev = device_of(gen)
    params, axes = merge(
        ("in_x", dense_init(gen, D, DI, "embed,inner", dtype)),
        ("in_z", dense_init(gen, D, DI, "embed,inner", dtype)),
        ("in_B", dense_init(gen, D, N, "embed,state", dtype)),
        ("in_C", dense_init(gen, D, N, "embed,state", dtype)),
        ("in_dt", dense_init(gen, D, NH, "embed,none", dtype, bias=True)),
        ("out", dense_init(gen, DI, D, "inner,embed", dtype)),
    )
    params["conv"] = trunc_normal(gen, (W, DI + 2 * N), 0.3, dtype)
    axes["conv"] = "conv,inner"
    params["A_log"] = torch.zeros((NH,), dtype=torch.float32, device=dev)
    axes["A_log"] = "none"
    params["D_res"] = torch.ones((NH,), dtype=torch.float32, device=dev)
    axes["D_res"] = "none"
    return params, axes


def _depthwise_causal_conv(x, w):
    """x (B,S,C), w (W,C): causal depthwise conv via shift-and-add, the
    taps added in the reference's order."""
    W = w.shape[0]
    S = x.shape[1]
    y = x * w[-1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S, :]
        y = y + shifted * w[W - 1 - i]
    return y


def _ssd_chunked(xh, dt, A, B_, C_, chunk, ctx=None,
                 h0: Optional[torch.Tensor] = None, head_block: int = 8):
    """SSD in chunked matmul form, processed in sequential head blocks.

    xh (B,S,NH,P) head-split inputs; dt (B,S,NH) post-softplus;
    A (NH,) negative decay; B_, C_ (B,S,N).
    Returns (y (B,S,NH,P) fp32, h_final (B,NH,N,P) fp32).

    The intra-chunk decay tensor is (B, nc, Q, Q, NH) fp32; a Python loop
    over blocks of ``head_block`` heads (the reference's ``lax.map``)
    keeps the live set to one block's worth — the blocks are independent.
    ``ctx`` is the reference's signature; nothing here reads it.
    Over DTensors, head parallel (``_ssd_shards``).
    """
    from torch.distributed.tensor import DTensor
    if isinstance(xh, DTensor):
        return _ssd_shards(xh, dt, A, B_, C_, chunk, h0, head_block)
    NH = xh.shape[2]
    hb = head_block
    while hb > 1 and NH % hb:
        hb -= 1
    if hb == NH:
        return _ssd_heads(xh, dt, A, B_, C_, chunk, h0)
    ys, hs = [], []
    for a in range(0, NH, hb):
        y_b, h_b = _ssd_heads(xh[:, :, a:a + hb], dt[:, :, a:a + hb],
                              A[a:a + hb], B_, C_, chunk,
                              None if h0 is None else h0[:, a:a + hb])
        ys.append(y_b)
        hs.append(h_b)
    return torch.cat(ys, axis=2), torch.cat(hs, axis=1)


def _ssd_shards(xh, dt, A, B_, C_, chunk, h0, head_block: int):
    """``_ssd_chunked`` over DTensors, head parallel as
    ``layers._attention_shards``: each rank runs its batch rows (split
    over ``data``) and its heads (over ``model``, where they divide) of
    ``xh``, ``dt``, ``A`` and ``h0`` on its local blocks, with ``B_`` and
    ``C_`` of its rows, which every head shares.  The heads are
    independent, so this is the one-device arithmetic; where nothing
    splits them the SSD runs whole on every ``model`` rank."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = xh.device_mesh
    B, S, NH, P = xh.shape
    split = _split_dims(mesh, B, NH, 2)
    rows = _rows(mesh, B)
    heads = {a: 0 for a in split if a == "model"}
    xl, place = _block(xh, mesh, split)
    dl, _ = _block(dt, mesh, split)
    al, _ = _block(A, mesh, heads, partial=tuple(rows))
    bl, _ = _block(B_, mesh, rows, partial=tuple(heads))
    cl, _ = _block(C_, mesh, rows, partial=tuple(heads))
    at_h = dict(rows, **{a: 1 for a in heads})
    hl = None if h0 is None else _block(h0, mesh, at_h)[0]
    y, h = _ssd_chunked(xl, dl, al, bl, cl, chunk, h0=hl,
                        head_block=head_block)
    h_place = [Shard(at_h[a]) if a in at_h else Replicate()
               for a in mesh.mesh_dim_names]
    return from_block(y, mesh, place, xh.shape), \
        from_block(h, mesh, h_place, (B, NH) + tuple(h.shape[2:]))


def _ssd_heads(xh, dt, A, B_, C_, chunk, h0: Optional[torch.Tensor] = None):
    """SSD core for one head block (see _ssd_chunked)."""
    f32 = torch.float32
    B, S, NH, P = xh.shape
    N = B_.shape[-1]
    nc = S // chunk

    def r(a):
        return a.reshape(B, nc, chunk, *a.shape[2:])

    xc, dtc, Bc, Cc = r(xh).to(f32), r(dt), r(B_).to(f32), r(C_).to(f32)

    dA = dtc * A[None, None, None, :]                      # (B,nc,Q,NH) <= 0
    cs = torch.cumsum(dA, axis=2)                          # within-chunk

    # ---- intra-chunk (quadratic) ----
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)            # (B,nc,Q,Q)
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=xh.device).tril()[None, None, :, :, None]
    # the exponent masked before the exp: above the diagonal it is
    # positive and may overflow (module docstring)
    decay = torch.exp(torch.where(
        tril, cs[:, :, :, None, :] - cs[:, :, None, :, :],
        float("-inf")))                                    # (B,nc,Q,K,NH)
    M = torch.where(tril, G[..., None] * decay * dtc[:, :, None, :, :], 0.0)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xc)

    # ---- chunk states ----
    seg = torch.exp(cs[:, :, -1:, :] - cs)                 # decay to chunk end
    state_c = torch.einsum("bckn,bckh,bckhp->bchnp", Bc, seg * dtc,
                           xc)                             # (B,nc,NH,N,P)

    # ---- inter-chunk recurrence ----
    total = torch.exp(cs[:, :, -1, :])                     # (B,nc,NH)
    h = (torch.zeros((B, NH, N, P), dtype=f32, device=xh.device)
         if h0 is None else h0.to(f32))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                   # state BEFORE chunk
        h = h * total[:, c, :, None, None] + state_c[:, c]
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(cs),
                           torch.stack(h_prev, axis=1))
    return reshape(y_intra + y_inter, B, S, NH, P), h


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype, device=None):
    """{h (B,NH,N,P) fp32, conv (B,W-1,DI+2N) dtype}, zeros."""
    NH, N, P = cfg.num_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    W, DI = cfg.ssm_conv_width, cfg.d_inner
    return {
        "h": torch.zeros((batch, NH, N, P), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, W - 1, DI + 2 * N), dtype=dtype,
                            device=device),
    }


def mamba_apply(p, x, ctx: ModelCtx, *, cache=None):
    """x (B,S,D) -> (y (B,S,D), new_cache).  A cache with S == 1 takes the
    decode recurrence; with S > 1 (prefill) the conv starts from zero
    padding, not from ``cache["conv"]``, the SSD from ``cache["h"]``, and
    the last W-1 rows of the conv input become the conv state, as in the
    reference.  ``dt`` is ``F.softplus`` of fp32, within 2.4e-7 relative
    of the reference's ``logaddexp(x, 0)`` on [-100, 100]."""
    cfg = ctx.cfg
    B, S, D = x.shape
    DI, N, NH, P = cfg.d_inner, cfg.ssm_state, cfg.num_ssm_heads, \
        cfg.ssm_head_dim
    f32 = torch.float32

    # the input whole over ``model`` before the projections: a residual
    # stream that is a partial sum there would have DTensor gather the
    # weights and run every projection on every ``model`` rank
    x = ctx.shard(x, ("batch", "none", "none"))
    xz = x @ p["in_x"]["w"]                                # (B,S,DI)
    z = x @ p["in_z"]["w"]
    Bp = x @ p["in_B"]["w"]                                # (B,S,N)
    Cp = x @ p["in_C"]["w"]
    dt = x @ p["in_dt"]["w"] + p["in_dt"]["b"]             # (B,S,NH)
    dt = F.softplus(dt.to(f32))
    A = -torch.exp(p["A_log"])                             # (NH,)

    # one layout for the join (on a mesh the three products come out
    # split differently, and DTensor's cat cannot reconcile them)
    xz, Bp, Cp = (ctx.shard(t, ("batch", "none", "none"))
                  for t in (xz, Bp, Cp))
    conv_in = torch.cat([xz, Bp, Cp], axis=-1)             # (B,S,DI+2N)

    if cache is None or S > 1:
        # full-sequence path (training, or prefill when a cache is given)
        conv_out = F.silu(_depthwise_causal_conv(conv_in, p["conv"]))
        xz_c, Bp_c, Cp_c = torch.split(conv_out, [DI, N, N], dim=-1)
        xh = reshape(xz_c, B, S, NH, P)
        xh = ctx.shard(xh, ("batch", "none", "heads_act", "none"))
        chunk = min(cfg.ssm_chunk, S)
        if S % chunk:
            chunk = S            # smoke shapes: single chunk
        h0 = None if cache is None else cache["h"]
        y, h_final = _ssd_chunked(xh, dt, A, Bp_c, Cp_c, chunk, ctx, h0=h0)
        if cache is None:
            new_cache = None
        else:
            W = cfg.ssm_conv_width
            new_cache = {"h": h_final, "conv": conv_in[:, -(W - 1):, :]}
    else:
        # decode: roll the conv window, O(1) state update
        window = torch.cat([cache["conv"], conv_in], axis=1)  # (B,W,·)
        conv_out = torch.einsum("bwc,wc->bc", window, p["conv"])[:, None, :]
        conv_out = F.silu(conv_out)
        xz_c, Bp_c, Cp_c = torch.split(conv_out, [DI, N, N], dim=-1)
        xh = reshape(xz_c, B, 1, NH, P)
        dA = torch.exp(dt[:, 0] * A[None, :])              # (B,NH)
        h = cache["h"] * dA[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", Bp_c[:, 0].to(f32), dt[:, 0],
            xh[:, 0].to(f32))
        y = torch.einsum("bn,bhnp->bhp", Cp_c[:, 0].to(f32),
                         h)[:, None]                       # (B,1,NH,P)
        new_cache = {"h": h, "conv": window[:, 1:, :]}

    y = y + xh.to(f32) * p["D_res"][None, None, :, None]
    y = reshape(y, B, S, DI).to(x.dtype)
    y = y * F.silu(z)
    return _out_proj(y, p["out"]["w"], ctx), new_cache


class _WholeGrad(torch.autograd.Function):
    """The identity, whose gradient a DTensor makes whole (``Replicate``)
    over every mesh axis where it is a partial sum."""

    @staticmethod
    def forward(ctx, x):
        return x.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate
        if not any(isinstance(p, Partial) for p in g.placements):
            return g
        return g.redistribute(g.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in g.placements])


def _out_proj(y, w, ctx: ModelCtx):
    """``y @ w`` of the block's output projection, made whole over
    ``model`` (a row-parallel product's partial sums all-reduced).  Its
    gradient comes in whole too: where the residual stream's gradient is
    a partial sum over ``model`` (the vocabulary-split logits' is),
    DTensor would run the product's backward on weights gathered whole on
    every ``model`` rank."""
    from torch.distributed.tensor import DTensor
    if not isinstance(y, DTensor):
        return y @ w
    return ctx.shard(_WholeGrad.apply(y @ w), ("batch", "none", "none"))
