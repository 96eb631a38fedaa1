"""The port's Mixture-of-Experts block (``repro_torch.models.moe``) against
the reference's (``repro.models.moe``) on the CPU, in fp32, from the same
numpy inputs: the capacity, the dispatch tables and the dropped set
exact; ``moe_apply`` (global and grouped routing, with and without
drops) and its gradients within 1e-5; ``aux_load_balance_loss`` within
1e-6; and the reference's own properties of the block."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro_torch import configs as port_configs
from repro_torch.models import layers as PL
from repro_torch.models import moe as PMOE
from repro_torch.params import from_numpy_tree, tree_leaves

TOL = 1e-5

# the smoke widths with each model's routing: deepseek-v2 top-6 of 16
# routed experts plus 2 shared, llama4-maverick top-1 of 8 plus 1 shared
VARIANTS = {
    "deepseek-v2": ("deepseek-v2-236b", dict(num_experts=16,
                                             experts_per_token=6,
                                             num_shared_experts=2)),
    "llama4-maverick": ("llama4-maverick-400b-a17b",
                        dict(num_experts=8, experts_per_token=1,
                             num_shared_experts=1)),
}
# a capacity factor under which tokens drop (2 x 64 tokens), and one under
# which none can (C >= T: an expert takes each token at most once)
DROPS, NO_DROPS = 0.5, 8.0


def _cfgs(variant, **kw):
    arch, routing = VARIANTS[variant]
    kw = {"dtype": "float32", **routing, **kw}
    return (dataclasses.replace(
                ref_configs.smoke_variant(ref_configs.get(arch)), **kw),
            dataclasses.replace(
                port_configs.smoke_variant(port_configs.get(arch)), **kw))


def _ctxs(variant, groups=1, **kw):
    ref, port = _cfgs(variant, **kw)
    return (RL.ModelCtx(cfg=ref, dtype=jnp.float32, moe_groups=groups),
            PL.ModelCtx(cfg=port, dtype=torch.float32, moe_groups=groups))


def _params(cfg, seed=0):
    """The reference's init, as numpy."""
    p, _ = RMOE.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def _x(cfg, b=2, s=64, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
            * scale).astype(np.float32)


def _probs(p, x, groups):
    """The router's fp32 probabilities (G, Tg, E), computed once in numpy
    so both packages route the same numbers; asserts that no token's k-th
    and (k+1)-th probabilities tie (top-k's tie rule is not compared)."""
    d = x.shape[-1]
    logits = x.reshape(-1, d).astype(np.float64) @ p["router"]["w"]
    logits -= logits.max(-1, keepdims=True)
    probs = np.exp(logits)
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    srt = -np.sort(-probs, axis=-1)
    assert np.all(srt[:, :-1] > srt[:, 1:])
    return probs.reshape(groups, -1, probs.shape[-1])


def _ref_tables(probs, k, capacity):
    """The reference's table construction (``_moe_grouped``'s
    ``build_tables`` after its sort, the global path being G = 1), on
    jnp."""
    G, Tg, E = probs.shape
    gate, eidx = jax.lax.top_k(jnp.asarray(probs), k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    n = Tg * k
    flat_e = eidx.reshape(G, n)
    flat_t = jnp.broadcast_to(
        jnp.repeat(jnp.arange(Tg, dtype=jnp.int32), k)[None], (G, n))
    flat_g = gate.reshape(G, n)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    first = jax.vmap(lambda s: jnp.searchsorted(s, s, side="left"))(sorted_e)
    pos = jnp.arange(n, dtype=jnp.int32)[None] - first
    keep = pos < capacity
    col = jnp.where(keep, pos, capacity)
    tok = jnp.take_along_axis(flat_t, order, axis=-1)
    gat = jnp.take_along_axis(flat_g, order, axis=-1)

    def build(se, co, ts, gs, kp):
        tab = jnp.full((E, capacity + 1), Tg, jnp.int32)
        tab = tab.at[se, co].set(jnp.where(kp, ts, Tg))
        gtab = jnp.zeros((E, capacity + 1), jnp.float32)
        gtab = gtab.at[se, co].set(jnp.where(kp, gs, 0.0))
        return tab[:, :capacity], gtab[:, :capacity]

    tab, gtab = jax.vmap(build)(sorted_e, col, tok, gat, keep)
    return np.asarray(tab), np.asarray(gtab), np.asarray(eidx)


def _dropped(table, eidx):
    """The (group, token, expert) assignments of top-k that no table slot
    holds."""
    G, E, _ = table.shape
    held = {(g, int(t), e) for g in range(G) for e in range(E)
            for t in table[g, e] if t < eidx.shape[1]}
    routed = {(g, t, int(e)) for g in range(G)
              for t in range(eidx.shape[1]) for e in eidx[g, t]}
    assert held <= routed
    return routed - held


@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("tokens", [1, 4, 24, 128, 1000])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_capacity(variant, tokens, factor):
    ref, port = _cfgs(variant, moe_capacity_factor=factor)
    assert PMOE._capacity(port, tokens) == RMOE._capacity(ref, tokens)
    assert PMOE._capacity(port, tokens) % 8 == 0


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("factor", [DROPS, NO_DROPS])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_route_tables_are_the_references(variant, factor, groups):
    """Given the same router probabilities, the token and gate tables are
    the reference's bitwise, so the dropped (token, expert) set is too:
    non-empty at the low capacity, empty at the high one."""
    ref, port = _cfgs(variant, moe_capacity_factor=factor)
    p = _params(ref)
    probs = _probs(p, _x(port), groups)
    cap = RMOE._capacity(ref, probs.shape[1])
    want_tab, want_gate, eidx = _ref_tables(probs, ref.experts_per_token,
                                            cap)
    tab, gate = PMOE._route(torch.from_numpy(probs), port.experts_per_token,
                            cap)
    assert tab.dtype == torch.int64 and gate.dtype == torch.float32
    assert np.array_equal(tab.numpy(), want_tab)
    assert gate.numpy().tobytes() == want_gate.tobytes()
    dropped = _dropped(tab.numpy(), eidx)
    assert dropped == _dropped(want_tab, eidx)
    assert bool(dropped) == (factor == DROPS)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("factor", [DROPS, NO_DROPS])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_apply(variant, factor, groups):
    """``moe_apply`` (routed plus shared experts) within 1e-5 of the
    reference's, global and in 2 groups, with and without drops."""
    rctx, pctx = _ctxs(variant, groups, moe_capacity_factor=factor)
    p = _params(rctx.cfg)
    x = _x(pctx.cfg)
    _probs(p, x, groups)                     # no top-k ties in the input
    want = RMOE.moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x), rctx)
    got = PMOE.moe_apply(from_numpy_tree(p, "cpu"), torch.from_numpy(x),
                         pctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_groups_that_do_not_divide_the_tokens():
    """``moe_groups`` lowered until it divides the tokens (3 of 4 → 2
    groups for 2 × 5 tokens), as in the reference."""
    rctx, pctx = _ctxs("deepseek-v2", 4, moe_capacity_factor=DROPS)
    assert PMOE._groups(pctx, 10) == 2 and PMOE._groups(pctx, 7) == 1
    p = _params(rctx.cfg)
    x = _x(pctx.cfg, s=5)
    want = RMOE.moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x), rctx)
    got = PMOE.moe_apply(from_numpy_tree(p, "cpu"), torch.from_numpy(x),
                         pctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("factor", [DROPS, NO_DROPS])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_gradients(variant, factor, groups):
    """The gradients of a scalar loss through ``moe_apply`` — to every
    param (the fp32 router included) and to the input — within 1e-5 of
    the reference's (relative to the largest entry above 1); a dropped
    gate's gradient is zero in both."""
    rctx, pctx = _ctxs(variant, groups, moe_capacity_factor=factor)
    p = _params(rctx.cfg)
    x = _x(pctx.cfg)
    _probs(p, x, groups)
    cot = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def ref_loss(params, xx):
        return jnp.sum(RMOE.moe_apply(params, xx, rctx) * jnp.asarray(cot))

    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    pp = from_numpy_tree(p, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(pp)]
    xt = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(PMOE.moe_apply(pp, xt, pctx) * torch.from_numpy(cot))
    grads = torch.autograd.grad(loss, leaves + [xt])
    for want, got in zip(jax.tree_util.tree_leaves(gp) + [gx], grads):
        want = np.asarray(want)
        tol = TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=tol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_aux_load_balance_loss(variant):
    ref, port = _cfgs(variant)
    p = _params(ref)
    x = _x(port, s=16)
    want = float(RMOE.aux_load_balance_loss(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), ref))
    got = PMOE.aux_load_balance_loss(from_numpy_tree(p, "cpu"),
                                     torch.from_numpy(x), port)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_moe_init_keeps_the_router_fp32():
    """``moe_init`` in bf16: the reference's tree (names, shapes, axes),
    the router fp32 and the experts bf16; the shared expert an MLP of
    ``d_ff · num_shared_experts``."""
    ref, port = _cfgs("deepseek-v2", dtype="bfloat16")
    rp, ra = RMOE.moe_init(jax.random.PRNGKey(0), ref, jnp.bfloat16)
    pp, pa = PMOE.moe_init(torch.Generator().manual_seed(0), port,
                           torch.bfloat16)
    assert pa == ra
    want = [(tuple(a.shape), np.dtype(a.dtype).name)
            for a in jax.tree_util.tree_leaves(rp)]
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in tree_leaves(pp)]
    assert got == want
    assert pp["router"]["w"].dtype == torch.float32
    assert pp["shared"]["wi"]["w"].shape == (port.d_model, 2 * port.d_ff)


def test_moe_routes_to_topk_and_balances():
    """The reference's first MoE property, on the port: top-1 llama4
    routing keeps the shape, is finite, and a zero input leaves only the
    shared expert's (small) output."""
    cfg = dataclasses.replace(port_configs.smoke_variant(
        port_configs.get("llama4-maverick-400b-a17b")), dtype="float32",
        moe_capacity_factor=4.0)
    ctx = PL.ModelCtx(cfg=cfg, dtype=torch.float32)
    p, _ = PMOE.moe_init(torch.Generator().manual_seed(0), cfg,
                         torch.float32)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.1
    y = PMOE.moe_apply(p, x, ctx)
    assert y.shape == x.shape and not bool(torch.isnan(y).any())
    y0 = PMOE.moe_apply(p, torch.zeros_like(x), ctx)
    assert float(torch.max(torch.abs(y0))) < 1.0


def test_moe_no_drop_matches_dense_computation():
    """The reference's second property, on the port: with top-k = E and a
    capacity that drops nothing, MoE is the gate-weighted sum of every
    expert MLP computed densely."""
    cfg = port_configs.smoke_variant(
        port_configs.get("llama4-maverick-400b-a17b"))
    cfg = dataclasses.replace(cfg, dtype="float32", num_experts=2,
                              experts_per_token=2, moe_capacity_factor=4.0,
                              num_shared_experts=0)
    ctx = PL.ModelCtx(cfg=cfg, dtype=torch.float32)
    p, _ = PMOE.moe_init(torch.Generator().manual_seed(0), cfg,
                         torch.float32)
    x = torch.randn((1, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.3
    y = PMOE.moe_apply(p, x, ctx)
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"]["w"], -1)
    want = sum((torch.nn.functional.silu(xf @ p["wi"][e])
                * (xf @ p["wg"][e])) @ p["wo"][e] * probs[:, e:e + 1]
               for e in range(2)).reshape(x.shape)
    torch.testing.assert_close(y, want, rtol=5e-4, atol=5e-4)


def test_moe_dshard_changes_nothing():
    """``moe_dshard`` only places the reference's shards: on one device
    the output is bitwise that without it."""
    ref, port = _cfgs("deepseek-v2", moe_capacity_factor=DROPS)
    p = from_numpy_tree(_params(ref), "cpu")
    x = torch.from_numpy(_x(port))
    a = PMOE.moe_apply(p, x, PL.ModelCtx(cfg=port, dtype=torch.float32))
    b = PMOE.moe_apply(p, x, PL.ModelCtx(cfg=port, dtype=torch.float32,
                                         moe_dshard=True))
    assert torch.equal(a, b)
