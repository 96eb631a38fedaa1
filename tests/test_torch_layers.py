"""The port's transformer layers (``repro_torch.models.layers``) against
the reference's (``repro.models.layers``) on the CPU, in fp32, from the
same numpy inputs: every output within 1e-5 (int8 cache values exact)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro_torch import configs as port_configs
from repro_torch.models import layers as PL
from repro_torch.params import from_numpy_tree

TOL = 1e-5


def _cfgs(arch="qwen2-0.5b", **kw):
    ref = dataclasses.replace(
        ref_configs.smoke_variant(ref_configs.get(arch)), dtype="float32",
        **kw)
    port = dataclasses.replace(
        port_configs.smoke_variant(port_configs.get(arch)), dtype="float32",
        **kw)
    return ref, port


def _ctxs(arch="qwen2-0.5b", q_chunk=512, kv_quant=False, **kw):
    ref, port = _cfgs(arch, **kw)
    return (RL.ModelCtx(cfg=ref, dtype=jnp.float32, q_chunk=q_chunk,
                        kv_quant=kv_quant),
            PL.ModelCtx(cfg=port, dtype=torch.float32, q_chunk=q_chunk,
                        kv_quant=kv_quant))


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("theta,fraction", [(10000.0, 1.0), (10000.0, 0.5),
                                            (1e6, 1.0), (0.0, 1.0)])
def test_rope(theta, fraction):
    """Full and half-dim (ChatGLM) rotation, half-split pairs; θ = 0 is
    the identity."""
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 9, 3, 32)
    pos = rng.integers(0, 600, size=(2, 9)).astype(np.int32)
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction)
    got = PL.rope(_t(x), _t(pos), theta, fraction)
    _close(want, got)
    if theta == 0.0:
        assert np.array_equal(got.numpy(), x)
    if fraction < 1:                         # the second half is untouched
        assert np.array_equal(got.numpy()[..., 16:], x[..., 16:])


def test_sinusoidal_positions():
    pos = np.arange(20, dtype=np.int32)[None].repeat(2, 0)
    _close(RL.sinusoidal_positions(jnp.asarray(pos), 64),
           PL.sinusoidal_positions(_t(pos), 64))


@pytest.mark.parametrize("kind,bias", [("rmsnorm", False),
                                       ("layernorm", False),
                                       ("layernorm", True)])
def test_norms(kind, bias):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 5, 48, scale=3.0) + 0.5
    p = {"scale": _rand(rng, 48) + 1.0}
    if bias:
        p["bias"] = _rand(rng, 48)
    want = RL.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = PL.norm_apply({k: _t(v) for k, v in p.items()}, _t(x), kind)
    _close(want, got)


@pytest.mark.parametrize("causal,window,q_chunk", [
    (True, 0, 512),          # causal, one block
    (True, 5, 512),          # sliding window
    (True, 0, 8),            # query-chunked: Sq = 16 in chunks of 8
    (True, 6, 4),            # chunked and windowed
    (False, 0, 512),         # bidirectional (cross-attention)
])
def test_attention_core(causal, window, q_chunk):
    """Causal, windowed and query-chunked attention, with empty (-1) key
    slots masked and GQA (4 query heads on 2 KV heads)."""
    rctx, pctx = _ctxs(q_chunk=q_chunk)
    rng = np.random.default_rng(2)
    B, S, T, H, KV, hd = 2, 16, 20, 4, 2, 32
    q, k, v = (_rand(rng, B, S, H, hd), _rand(rng, B, T, KV, hd),
               _rand(rng, B, T, KV, hd))
    kpos = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    kpos[:, -3:] = -1                                   # empty slots
    qpos = (np.arange(S, dtype=np.int32) + 2)[None].repeat(B, 0)
    want = RL.attention_core(*map(jnp.asarray, (q, k, v, kpos, qpos)), rctx,
                             causal=causal, window=window)
    got = PL.attention_core(*map(_t, (q, k, v, kpos, qpos)), pctx,
                            causal=causal, window=window)
    _close(want, got)


def _gqa_params(rng, cfg, bias=True):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {}
    for name, (fin, fout) in {"q": (D, H * hd), "k": (D, KV * hd),
                              "v": (D, KV * hd), "o": (H * hd, D)}.items():
        p[name] = {"w": _rand(rng, fin, fout, scale=fin ** -0.5)}
        if bias and name != "o":
            p[name]["b"] = _rand(rng, fout, scale=0.1)
    return p


def _jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "chatglm3-6b"])
def test_gqa_without_cache(arch):
    rctx, pctx = _ctxs(arch)
    rng = np.random.default_rng(3)
    p = _gqa_params(rng, pctx.cfg)
    x = _rand(rng, 2, 10, pctx.cfg.d_model)
    pos = np.arange(10, dtype=np.int32)[None].repeat(2, 0)
    want, wc = RL.gqa_apply(_jnp_tree(p), jnp.asarray(x), rctx,
                            jnp.asarray(pos))
    got, gc = PL.gqa_apply(from_numpy_tree(p, "cpu"), _t(x), pctx, _t(pos))
    assert wc is None and gc is None
    _close(want, got)


def test_gqa_cross_attention():
    """The cross-attention branches (plain code): prefill stores the
    context's K/V in the cache, decode reuses them."""
    rctx, pctx = _ctxs()
    rng = np.random.default_rng(4)
    p = _gqa_params(rng, pctx.cfg)
    D = pctx.cfg.d_model
    x, ctx_tokens = _rand(rng, 2, 6, D), _rand(rng, 2, 8, D)
    pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0)
    kv, hd = pctx.cfg.num_kv_heads, pctx.cfg.head_dim
    cache = {"k": np.zeros((2, 8, kv, hd), np.float32),
             "v": np.zeros((2, 8, kv, hd), np.float32),
             "kpos": np.full((2, 8), -1, np.int32)}
    rp, pp = _jnp_tree(p), from_numpy_tree(p, "cpu")
    want, wc = RL.gqa_apply(rp, jnp.asarray(x), rctx, jnp.asarray(pos),
                            kv_x=jnp.asarray(ctx_tokens), causal=False,
                            cache=_jnp_tree(cache))
    got, gc = PL.gqa_apply(pp, _t(x), pctx, _t(pos), kv_x=_t(ctx_tokens),
                           causal=False, cache=from_numpy_tree(cache, "cpu"))
    _close(want, got)
    for key in ("k", "v", "kpos"):
        _close(wc[key], gc[key])
    x1, pos1 = x[:, :1], np.full((2, 1), 6, np.int32)
    want, _ = RL.gqa_apply(rp, jnp.asarray(x1), rctx, jnp.asarray(pos1),
                           kv_x=jnp.asarray(ctx_tokens), causal=False,
                           cache=wc)
    got, _ = PL.gqa_apply(pp, _t(x1), pctx, _t(pos1), kv_x=_t(ctx_tokens),
                          causal=False, cache=gc)
    _close(want, got)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("window", [0, 4])
def test_gqa_prefill_then_decode_with_ring_wrap(kv_quant, window):
    """Prefill 7 tokens into a cache of 9 slots, then decode 6 more, one at
    a time: the ring buffer wraps at position 9 and overwrites the oldest
    slots; every output and the cache (int8 values exactly) match."""
    rctx, pctx = _ctxs(kv_quant=kv_quant)
    cfg = pctx.cfg
    rng = np.random.default_rng(5)
    p = _gqa_params(rng, cfg)
    rp, pp = _jnp_tree(p), from_numpy_tree(p, "cpu")
    B, T, KV, hd = 2, 9, cfg.num_kv_heads, cfg.head_dim
    dt = np.int8 if kv_quant else np.float32
    cache = {"k": np.zeros((B, T, KV, hd), dt),
             "v": np.zeros((B, T, KV, hd), dt),
             "kpos": np.full((B, T), -1, np.int32)}
    if kv_quant:
        cache["k_scale"] = np.zeros((B, T, KV), np.float32)
        cache["v_scale"] = np.zeros((B, T, KV), np.float32)
    rc, pc = _jnp_tree(cache), from_numpy_tree(cache, "cpu")
    x = _rand(rng, B, 13, cfg.d_model)
    steps = [(0, 7)] + [(t, t + 1) for t in range(7, 13)]
    for a, b in steps:
        pos = np.arange(a, b, dtype=np.int32)[None].repeat(B, 0)
        want, rc = RL.gqa_apply(rp, jnp.asarray(x[:, a:b]), rctx,
                                jnp.asarray(pos), cache=rc, window=window)
        got, pc = PL.gqa_apply(pp, _t(x[:, a:b]), pctx, _t(pos), cache=pc,
                               window=window)
        _close(want, got)
        assert np.array_equal(np.asarray(rc["kpos"]), pc["kpos"].numpy())
        if kv_quant:
            assert np.array_equal(np.asarray(rc["k"]), pc["k"].numpy())
            assert np.array_equal(np.asarray(rc["v"]), pc["v"].numpy())
            _close(rc["k_scale"], pc["k_scale"])
        else:
            _close(rc["k"], pc["k"])
    assert sorted(pc["kpos"][0].tolist()) == list(range(4, 13))


def test_quantize_kv_round_half_to_even():
    """The int8 cache: values exact (round half to even, as jnp.round),
    scales and the dequantized tensor within 1e-5."""
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 5, 3, 16)
    x[0, 0, 0, :] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 10,
                             np.float32)                # exact halves
    wq, ws = RL.quantize_kv(jnp.asarray(x))
    gq, gs = PL.quantize_kv(_t(x))
    assert gq.dtype == torch.int8
    assert np.array_equal(np.asarray(wq), gq.numpy())
    _close(ws, gs)
    _close(RL.dequantize_kv(wq, ws, jnp.float32),
           PL.dequantize_kv(gq, gs, torch.float32))


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp_apply(activation):
    """Gated SiLU (the activation on ``wi``) and ungated tanh-GELU with
    biases."""
    rctx, pctx = _ctxs(activation=activation)
    cfg = pctx.cfg
    rng = np.random.default_rng(7)
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"wi": {"w": _rand(rng, D, Fd, scale=D ** -0.5)},
         "wo": {"w": _rand(rng, Fd, D, scale=Fd ** -0.5)}}
    if activation == "silu":
        p["wg"] = {"w": _rand(rng, D, Fd, scale=D ** -0.5)}
    else:
        p["wi"]["b"] = _rand(rng, Fd, scale=0.1)
        p["wo"]["b"] = _rand(rng, D, scale=0.1)
    x = _rand(rng, 2, 6, D)
    _close(RL.mlp_apply(_jnp_tree(p), jnp.asarray(x), rctx),
           PL.mlp_apply(from_numpy_tree(p, "cpu"), _t(x), pctx))


def _mla_params(rng, cfg):
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
    return {name: {"w": _rand(rng, fin, fout, scale=fin ** -0.5)}
            for name, (fin, fout) in {"q": (D, H * (hd + rd)),
                                      "kv_down": (D, r + rd),
                                      "kv_up": (r, H * 2 * hd),
                                      "o": (H * hd, D)}.items()}


def test_mla_init_is_the_references_tree():
    """MLA's four projections: the reference's names, shapes and axes."""
    rctx, pctx = _ctxs("deepseek-v2-236b")
    rp, ra = RL.mla_init(jax.random.PRNGKey(0), rctx.cfg, jnp.float32)
    pp, pa = PL.mla_init(torch.Generator().manual_seed(0), pctx.cfg,
                         torch.float32)
    assert pa == ra
    assert {k: tuple(v["w"].shape) for k, v in pp.items()} == \
        {k: tuple(v["w"].shape) for k, v in rp.items()}
    assert all(v["w"].dtype == torch.float32 for v in pp.values())


@pytest.mark.parametrize("q_chunk", [512, 8, 4])
def test_mla_train_forward(q_chunk):
    """A cache-less MLA forward of 16 tokens, unchunked and query-chunked
    (chunks of 8 and 4: the checkpointed path while autograd records),
    within 1e-5 of the reference's; its gradients (to the params and the
    input) within 1e-5 of the reference's too, relative to the largest
    entry where that is above 1."""
    rctx, pctx = _ctxs("deepseek-v2-236b", q_chunk=q_chunk)
    rng = np.random.default_rng(8)
    p = _mla_params(rng, pctx.cfg)
    x = _rand(rng, 2, 16, pctx.cfg.d_model)
    pos = np.arange(16, dtype=np.int32)[None].repeat(2, 0)
    cot = _rand(rng, 2, 16, pctx.cfg.d_model)

    def ref_loss(params, xx):
        y, _ = RL.mla_apply(params, xx, rctx, jnp.asarray(pos))
        return jnp.sum(y * jnp.asarray(cot)), y

    (_, want), (gp, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1),
                                             has_aux=True)(
        _jnp_tree(p), jnp.asarray(x))
    pp = from_numpy_tree(p, "cpu")
    leaves = [pp[k]["w"].requires_grad_() for k in sorted(pp)]
    xt = _t(x).requires_grad_()
    got, cache = PL.mla_apply(pp, xt, pctx, _t(pos))
    assert cache is None
    _close(want, got)
    grads = torch.autograd.grad(torch.sum(got * _t(cot)), leaves + [xt])
    for k, g in zip(sorted(pp), grads):
        scale = max(1.0, float(np.abs(gp[k]["w"]).max()))
        _close(gp[k]["w"], g, tol=TOL * scale)
    _close(gx, grads[-1])


def test_mla_chunked_equals_unchunked():
    """The chunked prefill is the unchunked one within fp32 rounding."""
    _, whole = _ctxs("deepseek-v2-236b", q_chunk=512)
    _, chunked = _ctxs("deepseek-v2-236b", q_chunk=4)
    rng = np.random.default_rng(9)
    pp = from_numpy_tree(_mla_params(rng, whole.cfg), "cpu")
    x = _t(_rand(rng, 2, 16, whole.cfg.d_model))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    with torch.no_grad():
        a, _ = PL.mla_apply(pp, x, whole, pos)
        b, _ = PL.mla_apply(pp, x, chunked, pos)
    _close(a.numpy(), b)


def test_mla_prefill_then_decode_with_ring_wrap():
    """Prefill 7 tokens into a latent cache of 9 slots, then decode 6
    more one at a time: the ring wraps at position 9; every output and
    the cache (ckv, krope within 1e-5, kpos exact) are the reference's,
    and the cache holds the last 9 positions."""
    rctx, pctx = _ctxs("deepseek-v2-236b")
    cfg = pctx.cfg
    rng = np.random.default_rng(10)
    p = _mla_params(rng, cfg)
    rp, pp = _jnp_tree(p), from_numpy_tree(p, "cpu")
    B, T = 2, 9
    rc = RL.mla_cache_init(rctx.cfg, B, T, jnp.float32)
    pc = PL.mla_cache_init(cfg, B, T, torch.float32, "cpu")
    assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in rc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in pc.items()}
    x = _rand(rng, B, 13, cfg.d_model)
    for a, b in [(0, 7)] + [(t, t + 1) for t in range(7, 13)]:
        pos = np.arange(a, b, dtype=np.int32)[None].repeat(B, 0)
        want, rc = RL.mla_apply(rp, jnp.asarray(x[:, a:b]), rctx,
                                jnp.asarray(pos), cache=rc)
        got, pc = PL.mla_apply(pp, _t(x[:, a:b]), pctx, _t(pos), cache=pc)
        _close(want, got)
        assert np.array_equal(np.asarray(rc["kpos"]), pc["kpos"].numpy())
        _close(rc["ckv"], pc["ckv"])
        _close(rc["krope"], pc["krope"])
    assert sorted(pc["kpos"][0].tolist()) == list(range(4, 13))
