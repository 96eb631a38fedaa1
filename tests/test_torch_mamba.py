"""The port's Mamba2 / SSD block (``repro_torch.models.mamba``) against the
reference's (``repro.models.mamba``) on the CPU, in fp32 at the smoke
widths (d_model 256, 32 SSD heads of 16, state 16, so 4 head blocks of
8), from the same numpy inputs, the reference's params carried across
with ``params.from_numpy_tree``.  Tolerances: the depthwise conv 1e-6;
the chunked SSD 2e-4, the reference's own against its naive recurrence
(``tests/test_layers.py``); ``mamba_apply``'s branches, their caches and
gradients 1e-5; at the published chunk of 256 the forward 1e-5 of the
reference's and the gradients, finite where the reference's are not,
2e-4 of the reference's at chunk 16 on the same inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import mamba as RM
from repro.models.layers import ModelCtx as RefCtx
from repro_torch import configs as port_configs
from repro_torch.models import mamba as PM
from repro_torch.models.layers import ModelCtx
from repro_torch.params import from_numpy_tree, tree_leaves, tree_unflatten

ARCH = "mamba2-2.7b"


def _block(chunk=16):
    """(ref cfg and ctx, port cfg and ctx, ref params, port params): one
    smoke-width block in fp32 at ``ssm_chunk`` = chunk."""
    ref_cfg = dataclasses.replace(
        ref_configs.smoke_variant(ref_configs.get(ARCH)), dtype="float32",
        ssm_chunk=chunk)
    port_cfg = dataclasses.replace(
        port_configs.smoke_variant(port_configs.get(ARCH)), dtype="float32",
        ssm_chunk=chunk)
    rp, _ = RM.mamba_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    pp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return (RefCtx(cfg=ref_cfg, dtype=jnp.float32),
            ModelCtx(cfg=port_cfg, dtype=torch.float32), rp, pp)


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _ssd_inputs(nh, h0, seed=0):
    rng = np.random.default_rng(seed)
    B, S, P, N = 2, 32, 4, 5
    arrs = (rng.normal(size=(B, S, nh, P)),
            rng.uniform(0.1, 0.9, size=(B, S, nh)),
            -rng.uniform(0.5, 1.5, size=(nh,)),
            rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N)),
            rng.normal(size=(B, nh, N, P)) if h0 else None)
    return [None if a is None else a.astype(np.float32) for a in arrs]


def naive_ssd(xh, dt, A, B_, C_, h0=None):
    """The O(S·N·P) recurrence in torch (the reference test's
    ``naive_ssd``): h = h·exp(dt·A) + dt·(B ⊗ x); y = C·h."""
    B, S, NH, P = xh.shape
    h = torch.zeros((B, NH, B_.shape[-1], P)) if h0 is None else h0
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])
        h = h * dA[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", B_[:, t], dt[:, t], xh[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", C_[:, t], h))
    return torch.stack(ys, axis=1), h


@pytest.mark.parametrize("seq", [2, 10])
def test_depthwise_causal_conv(seq):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, seq, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    want = RM._depthwise_causal_conv(jnp.asarray(x), jnp.asarray(w))
    _close(PM._depthwise_causal_conv(torch.from_numpy(x),
                                     torch.from_numpy(w)), want, 1e-6)


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("nh", [3, 12, 32])
@pytest.mark.parametrize("h0", [False, True])
def test_ssd_chunked(chunk, nh, h0):
    """Head blocks of 3, 6 and 8 (the reference's rule), with and without
    a carried state, against the reference's ``_ssd_chunked`` and the
    torch recurrence."""
    arrs = _ssd_inputs(nh, h0)
    want_y, want_h = RM._ssd_chunked(
        *[jnp.asarray(a) for a in arrs[:5]], chunk, None,
        h0=None if arrs[5] is None else jnp.asarray(arrs[5]))
    ts = [None if a is None else torch.from_numpy(a) for a in arrs]
    y, h = PM._ssd_chunked(*ts[:5], chunk, None, h0=ts[5])
    assert y.dtype == h.dtype == torch.float32
    _close(y, want_y, 2e-4)
    _close(h, want_h, 2e-4)
    ny, nh_ = naive_ssd(*ts)
    torch.testing.assert_close(y, ny, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, nh_, rtol=2e-4, atol=2e-4)


def _ref_cache(cfg, seed=5):
    rng = np.random.default_rng(seed)
    c = RM.mamba_cache_init(cfg, 2, jnp.float32)
    return {k: rng.normal(size=v.shape).astype(np.float32) * 0.5
            for k, v in c.items()}


@pytest.mark.parametrize("branch", ["train", "prefill", "decode"])
def test_mamba_apply_branches(branch):
    """Training (no cache, 2 chunks of 16), a prefill of 24 tokens into a
    cache (the SSD from its ``h``, the conv from zero padding; the new
    cache's ``conv`` the last 3 conv inputs) and one decode step (the
    rolled window, the O(1) recurrence): outputs and caches within
    1e-5."""
    rctx, pctx, rp, pp = _block()
    x = _x(pctx.cfg, 2, {"train": 32, "prefill": 24, "decode": 1}[branch])
    cache = None if branch == "train" else _ref_cache(pctx.cfg)
    if cache is not None:
        zeros = PM.mamba_cache_init(pctx.cfg, 2, torch.float32)
        assert {k: tuple(v.shape) for k, v in zeros.items()} == \
            {k: v.shape for k, v in cache.items()}
    want, wc = RM.mamba_apply(rp, jnp.asarray(x), rctx, cache=None
                              if cache is None else
                              jax.tree_util.tree_map(jnp.asarray, cache))
    got, gc = PM.mamba_apply(pp, torch.from_numpy(x), pctx, cache=None
                             if cache is None else
                             {k: torch.from_numpy(v) for k, v in
                              cache.items()})
    _close(got, want, 1e-5)
    assert (gc is None) == (wc is None)
    if gc is not None:
        assert sorted(gc) == sorted(wc) == ["conv", "h"]
        for k in gc:
            assert gc[k].shape == wc[k].shape
            _close(gc[k], wc[k], 1e-5)


def _grads_ref(rp, x, rctx):
    return jax.value_and_grad(lambda p: jnp.mean(
        RM.mamba_apply(p, jnp.asarray(x), rctx)[0] ** 2))(rp)


def _grads_port(pp, x, pctx):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(pp)]
    y, _ = PM.mamba_apply(tree_unflatten(pp, leaves), torch.from_numpy(x),
                          pctx)
    loss = torch.mean(y ** 2)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def test_gradients_at_chunk_16():
    """The gradients of mean(y²) over every leaf, 2 chunks of 16."""
    rctx, pctx, rp, pp = _block()
    x = _x(pctx.cfg, 2, 32)
    wl, wg = _grads_ref(rp, x, rctx)
    gl, gg = _grads_port(pp, x, pctx)
    assert float(gl) == pytest.approx(float(wl), rel=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(wg), gg):
        _close(b, a, 1e-5)


def test_published_chunk_has_finite_gradients():
    """Seq 256 at the published chunk of 256: the reference's backward
    meets exp overflow above the diagonal (0 · inf), the port's does not.
    Its forward is the reference's within 1e-5; its gradients are finite
    and within 2e-4 of the reference's at chunk 16 on the same inputs,
    which the SSD's chunk invariance makes the same function."""
    rctx, pctx, rp, pp = _block(chunk=256)
    x = _x(pctx.cfg, 1, 256)
    want, _ = RM.mamba_apply(rp, jnp.asarray(x), rctx)
    got, _ = PM.mamba_apply(pp, torch.from_numpy(x), pctx)
    _close(got, want, 1e-5)
    _, ref256 = _grads_ref(rp, x, rctx)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree_util.tree_leaves(ref256))
    gl, gg = _grads_port(pp, x, pctx)
    assert all(bool(torch.isfinite(g).all()) for g in gg)
    rctx16, _, _, _ = _block(chunk=16)
    wl, wg = _grads_ref(rp, x, rctx16)
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree_util.tree_leaves(wg))
    assert float(gl) == pytest.approx(float(wl), rel=2e-4)
    for a, b in zip(jax.tree_util.tree_leaves(wg), gg):
        _close(b, a, 2e-4)


def test_init_matches_the_references_tree():
    """``mamba_init``'s leaves, shapes, dtypes and axes are the
    reference's; ``A_log`` zeros and ``D_res`` ones in fp32 under a bf16
    block; ``gen=None`` builds on the meta device."""
    cfg = port_configs.smoke_variant(port_configs.get(ARCH))
    rp, ra = RM.mamba_init(jax.random.PRNGKey(0),
                           ref_configs.smoke_variant(ref_configs.get(ARCH)),
                           jnp.bfloat16)
    pp, pa = PM.mamba_init(torch.Generator().manual_seed(0), cfg,
                           torch.bfloat16)
    want = {"/".join(str(k.key) for k in path): (leaf.shape,
                                                 np.dtype(leaf.dtype).name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]}
    from repro_torch.params import tree_paths
    got = {"/".join(p): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_paths(pp)}
    assert got == want
    assert [a for _, a in tree_paths(pa)] == jax.tree_util.tree_leaves(ra)
    assert torch.equal(pp["A_log"], torch.zeros(cfg.num_ssm_heads))
    assert torch.equal(pp["D_res"], torch.ones(cfg.num_ssm_heads))
    assert float(pp["conv"].float().abs().max()) <= 0.6 + 1e-3
    meta, _ = PM.mamba_init(None, cfg, torch.bfloat16)
    assert all(t.device.type == "meta" for t in tree_leaves(meta))


def test_softplus_is_the_references():
    """``mamba_apply``'s ``F.softplus`` against the reference's
    ``jax.nn.softplus`` (``logaddexp(x, 0)``) in fp32 on [-100, 100]:
    within 2.4e-7 relative, two ulps, wherever the reference's value is
    nonzero; where XLA flushes a subnormal result to 0, the port's is
    below the smallest normal fp32."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=100_000) * 8,
                        np.linspace(-100, 100, 100_001)]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)), np.float64)
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    nz = want > 0
    assert np.max(np.abs(got[nz] - want[nz]) / want[nz]) <= 2.4e-7
    assert np.all(got[~nz] < np.finfo(np.float32).tiny)
