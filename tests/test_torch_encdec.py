"""The port's encoder and cross-attention (``repro_torch.models``:
``transformer.encode``, the ``cross`` sublayer, ``model_zoo``'s context
inputs and cross caches) against the reference's on the CPU, on the smoke
variants of whisper-medium (2 encoder and 2 decoder layers, 16 frames)
and llama-3.2-vision-11b (2 layers, 8 patch tokens), with the
reference's initial params carried across (``params.from_numpy_tree``)
and the same context embeddings (normal, scale 1/sqrt(d_model), from a
numpy seed).  Tolerances, in fp32: ``encode`` and ``forward_hidden``
within 1e-5; the loss and every gradient leaf (the encoder's and the
cross sublayers' among them) rtol 1e-4 with an absolute floor of 1e-6;
prefill and decode logits within 2e-4 of the reference's and of the
port's own cache-less forward, greedy ids equal (the standard of
``tests/test_models_smoke.py::test_decode_matches_full_forward``); trees,
shapes and dtypes exact."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.config import INPUT_SHAPES as REF_SHAPES
from repro.models import model_zoo as ref_zoo
from repro.models import transformer as RT
from repro_torch import configs as port_configs
from repro_torch.config import INPUT_SHAPES
from repro_torch.models import model_zoo as port_zoo
from repro_torch.models import transformer as PT
from repro_torch.params import (from_numpy_tree, to_numpy_tree, tree_leaves,
                                tree_paths)

ARCHS = ["whisper-medium", "llama-3.2-vision-11b"]
WHISPER, VISION = ARCHS


def _cfgs(arch, **kw):
    return (dataclasses.replace(
                ref_configs.smoke_variant(ref_configs.get(arch)), **kw),
            dataclasses.replace(
                port_configs.smoke_variant(port_configs.get(arch)), **kw))


def _pair(arch, dtype="float32", **build_kw):
    """(ref bundle, port bundle, ref params, the same params in torch)."""
    ref_cfg, port_cfg = _cfgs(arch, dtype=dtype)
    rb = ref_zoo.build(ref_cfg, **build_kw)
    pb = port_zoo.build(port_cfg, device="cpu", **build_kw)
    rp, _ = rb.init(jax.random.PRNGKey(0))
    return rb, pb, rp, from_numpy_tree(jax.tree_util.tree_map(np.asarray,
                                                              rp), "cpu")


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p),
             tuple(leaf.shape), np.dtype(leaf.dtype).name)
            for p, leaf in flat]


def _port_paths(tree):
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_paths(tree)]


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _embeds(cfg, b, seed=3):
    """(key, (b, T, D) fp32 embeddings): normal, scale 1/sqrt(d_model)."""
    key, t_ctx = port_zoo.context_input(cfg)
    x = np.random.default_rng(seed).normal(size=(b, t_ctx, cfg.d_model))
    return key, (x / math.sqrt(cfg.d_model)).astype(np.float32)


def _batches(cfg, b, s, seed=3):
    """The same batch for both packages: tokens, targets, embeddings."""
    key, emb = _embeds(cfg, b, seed)
    nb = {"tokens": _tokens(cfg, b, s), "targets": _tokens(cfg, b, s, 2),
          key: emb}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _context(bundle, params, batch, ctx_fn):
    """The context tokens a cache-less forward reads: the encoder's output
    or the patch embeddings as given."""
    key, _ = port_zoo.context_input(bundle.cfg)
    if bundle.cfg.encoder_layers:
        return ctx_fn(params, bundle.cfg, batch[key], bundle.ctx)
    return batch[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_is_the_references(arch):
    """Paths, shapes and dtypes of the smoke variant's params and axes in
    flatten order: whisper's ``encoder`` subtree ({stack, final_norm},
    sorted between ``embed`` and ``final_norm``) and each cross layer's
    ``cross`` and ``cross_norm``."""
    ref_cfg, port_cfg = _cfgs(arch)
    rp, ra = ref_zoo.build(ref_cfg).init(jax.random.PRNGKey(0))
    pp, pa = port_zoo.build(port_cfg, device="cpu").init(0)
    assert _port_paths(pp) == _ref_paths(rp)
    assert [leaf for _, leaf in tree_paths(pa)] == \
        jax.tree_util.tree_leaves(ra)
    paths = [p for p, _ in tree_paths(pp)]
    assert ("stack", "l1", "cross", "q", "w") in paths
    assert ("stack", "l1", "cross_norm", "scale") in paths
    assert (("encoder", "stack", "attn", "q", "w") in paths) == \
        (arch == WHISPER)


@pytest.mark.parametrize("arch,depth,params,leaves,scored", [
    (WHISPER, 24, 811_358_208, 36, 32),
    (VISION, 40, 10_110_734_336, 53, 52),
    (VISION, 5, 2_183_184_384, 53, 52),
])
def test_full_width_shapes_on_meta(arch, depth, params, leaves, scored):
    """whisper-medium uncut and llama-3.2-vision at its 40 layers and at
    one period of its pattern (4 self, 1 cross), on the meta device
    against the reference's ``jax.eval_shape``: the tree, its parameter
    count and the scored leaves (ndim >= 2).  ``param_count()``, the
    reference's closed form (the port's is the same), is the vision
    tree's count; for whisper it counts a gated MLP (3 d d_ff) where the
    gelu MLP holds 2 d d_ff + d_ff + d, and no norm bias: 200,954,880
    more than the tree."""
    ref_cfg = dataclasses.replace(ref_configs.get(arch), num_layers=depth)
    port_cfg = dataclasses.replace(port_configs.get(arch), num_layers=depth)
    shapes = jax.eval_shape(
        lambda k: ref_zoo.build(ref_cfg).init(k)[0], jax.random.PRNGKey(0))
    tree, _ = PT.init_model(port_cfg, None)
    assert _port_paths(tree) == _ref_paths(shapes)
    got = tree_paths(tree)
    assert all(t.device.type == "meta" for _, t in got)
    assert len(got) == leaves and sum(t.ndim >= 2 for _, t in got) == scored
    n = sum(t.numel() for _, t in got)
    assert n == params
    d, f = port_cfg.d_model, port_cfg.d_ff
    if arch == WHISPER:
        layers = port_cfg.num_layers + port_cfg.encoder_layers
        norm_bias = d * (3 * port_cfg.num_layers
                         + 2 * port_cfg.encoder_layers + 3)
        assert port_cfg.param_count() == ref_cfg.param_count() == \
            n + layers * (3 * d * f - (2 * d * f + f + d)) - norm_bias
    else:
        assert port_cfg.param_count() == ref_cfg.param_count() == n


def test_encode_is_the_references():
    """whisper's encoder over the same frame embeddings, within 1e-5."""
    rb, pb, rp, pp = _pair(WHISPER)
    key, emb = _embeds(pb.cfg, 2)
    want = RT.encode(rp, rb.cfg, jnp.asarray(emb), rb.ctx)
    got = PT.encode(pp, pb.cfg, torch.from_numpy(emb), pb.ctx)
    assert key == "audio_embeds" and tuple(got.shape) == (
        2, pb.cfg.encoder_seq, pb.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_with_context(arch):
    """``forward_hidden`` with ``aux`` (the encoder's output, or the patch
    embeddings as given): hidden states within 1e-5 of the reference's,
    and the context moves them (the cross sublayers are not a no-op)."""
    rb, pb, rp, pp = _pair(arch)
    rbatch, pbatch = _batches(pb.cfg, 2, 12)
    raux = _context(rb, rp, rbatch, RT.encode)
    paux = _context(pb, pp, pbatch, PT.encode)
    want, _ = RT.forward_hidden(rp, rb.cfg, rbatch["tokens"], rb.ctx,
                                aux=raux)
    got, _ = PT.forward_hidden(pp, pb.cfg, pbatch["tokens"], pb.ctx,
                               aux=paux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    other, _ = PT.forward_hidden(pp, pb.cfg, pbatch["tokens"], pb.ctx,
                                 aux=2 * paux)
    assert float((other - got).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(arch):
    """``loss_fn`` with the context in the batch, against
    ``jax.value_and_grad`` of the reference's: the loss and the gradient
    of every leaf (the encoder's, ``cross`` and ``cross_norm`` among
    them) within rtol 1e-4 (absolute floor 1e-6), the encoder under
    ``torch.utils.checkpoint``."""
    rb, pb, rp, pp = _pair(arch)
    rbatch, pbatch = _batches(pb.cfg, 2, 12)
    wl, wg = jax.value_and_grad(rb.loss_fn)(rp, rbatch)
    gl, gg = port_zoo.value_and_grad(pb.loss_fn, pp, pbatch)
    assert float(gl) == pytest.approx(float(wl), rel=1e-4)
    paths = [p for p, _ in tree_paths(gg)]
    for p, a, b in zip(paths, jax.tree_util.tree_leaves(wg),
                       tree_leaves(gg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6, err_msg=str(p))
    moved = {p[:3] for p, g in tree_paths(gg) if bool(g.abs().max() > 0)}
    assert ("stack", "l1", "cross") in moved
    if arch == WHISPER:
        assert ("encoder", "stack", "attn") in moved


def test_encoder_remat_changes_no_gradient():
    """``encode`` under ``torch.utils.checkpoint`` (the bundle's default)
    and without it: the same loss and gradients, bitwise."""
    _, port_cfg = _cfgs(WHISPER, dtype="float32")
    pb = port_zoo.build(port_cfg, device="cpu")
    params, _ = pb.init(0)
    _, pbatch = _batches(port_cfg, 2, 12)
    (l0, g0), (l1, g1) = [
        port_zoo.value_and_grad(fn, params, pbatch) for fn in (
            pb.loss_fn, lambda p, b: _loss_without_encoder_remat(pb, p, b))]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


def _loss_without_encoder_remat(pb, params, batch):
    aux = PT.encode(params, pb.cfg, batch["audio_embeds"], pb.ctx,
                    remat=False)
    h, _ = PT.forward_hidden(params, pb.cfg, batch["tokens"], pb.ctx,
                             aux=aux)
    return PT.chunked_ce_loss(params, pb.cfg, h, batch["targets"], pb.ctx)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_loss_fn(arch, dtype, rtol):
    """The loss with the context in the batch in the model's dtype: 1e-5
    in fp32, 2e-2 relative in bf16 (the tolerances of
    ``tests/test_torch_models.py::test_loss_fn``)."""
    rb, pb, rp, pp = _pair(arch, dtype)
    rbatch, pbatch = _batches(pb.cfg, 2, 16)
    key, _ = port_zoo.context_input(pb.cfg)
    rbatch[key] = rbatch[key].astype(jnp.dtype(dtype))
    pbatch[key] = pbatch[key].to(pb.ctx.dtype)
    want = float(rb.loss_fn(rp, rbatch))
    got = float(pb.loss_fn(pp, pbatch))
    assert got == pytest.approx(want, rel=rtol, abs=rtol)


@pytest.mark.parametrize("arch,kv_quant", [(WHISPER, False), (VISION, False),
                                           (WHISPER, True), (VISION, True)])
def test_prefill_then_decode(arch, kv_quant):
    """Prefill 8 tokens into fresh caches of 10 slots with the context in
    the batch, then 4 decode steps that read ``ctx_tokens`` (the ring
    wraps at position 10): logits within 2e-4 of the reference's, greedy
    ids equal, the caches within 1e-5; without int8, before the wrap,
    the port's own cache-less forward within 2e-4.  The cross cache holds
    the context's K/V from the prefill on, unchanged by decode."""
    rb, pb, rp, pp = _pair(arch, kv_quant=kv_quant, remat=False)
    key, emb = _embeds(pb.cfg, 2)
    toks = _tokens(pb.cfg, 2, 12)
    wl, wc = rb.prefill_step(rp, {"tokens": jnp.asarray(toks[:, :8]),
                                  key: jnp.asarray(emb),
                                  "caches": rb.make_cache(2, 10)})
    gl, gc = pb.prefill_step(pp, {"tokens": torch.from_numpy(toks[:, :8]),
                                  key: torch.from_numpy(emb),
                                  "caches": pb.make_cache(2, 10)})
    assert sorted(gc) == ["ctx_tokens", "layers"]
    aux = _context(pb, pp, {key: torch.from_numpy(emb)}, PT.encode)
    assert torch.equal(gc["ctx_tokens"], aux)
    cross = gc["layers"]["stack"]["l1"]["cross"]
    assert bool((cross["kpos"] >= 0).all())
    h, _ = PT.forward_hidden(pp, pb.cfg, torch.from_numpy(toks), pb.ctx,
                             aux=aux)
    full = PT.logits_from_hidden(pp, pb.cfg, h)
    steps = [(7, wl, gl)]
    for t in range(8, 12):
        wl, wc = rb.decode_step(rp, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "pos": jnp.full((2, 1), t, jnp.int32), "caches": wc})
        gl, gc = pb.decode_step(pp, {
            "token": torch.from_numpy(toks[:, t:t + 1]),
            "pos": torch.full((2, 1), t, dtype=torch.int32), "caches": gc})
        steps.append((t, wl, gl))
    for t, w, g in steps:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=0)
        assert np.array_equal(np.argmax(np.asarray(w), -1),
                              torch.argmax(g, -1).numpy())
        if not kv_quant and t < 10:
            np.testing.assert_allclose(g.numpy(), full[:, t].numpy(),
                                       atol=2e-4, rtol=0)
    assert _port_paths(gc) == _ref_paths(wc)
    for a, b in zip(jax.tree_util.tree_leaves(wc),
                    tree_leaves(to_numpy_tree(gc))):
        np.testing.assert_allclose(b, np.asarray(a, b.dtype), atol=1e-5,
                                   rtol=1e-5)
    for name in ("k", "v", "kpos"):
        assert torch.equal(gc["layers"]["stack"]["l1"]["cross"][name],
                           cross[name])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_input_specs_are_the_references(arch, shape, kv_quant):
    """Batches and cache trees at the assigned shapes as published: the
    embeddings (``audio_embeds`` (B, 1500, 1024), ``image_embeds``
    (B, 1024, 4096)) in train and prefill, ``ctx_tokens`` beside the
    decode caches, and each cross layer's ``{k, v, kpos}`` over the
    context, in the model dtype even under ``kv_quant``."""
    ref_cfg, port_cfg = ref_configs.get(arch), port_configs.get(arch)
    want = ref_zoo.build(ref_cfg, kv_quant=kv_quant).input_specs(
        REF_SHAPES[shape])
    got = port_zoo.build(port_cfg, device="cpu", kv_quant=kv_quant
                         ).input_specs(INPUT_SHAPES[shape])
    assert _port_paths(got) == _ref_paths(want)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    key, t_ctx = port_zoo.context_input(port_cfg)
    B = INPUT_SHAPES[shape].global_batch
    if shape == "decode_32k":
        ctx = got["caches"]["ctx_tokens"]
        unit = got["caches"]["layers"]["stack"]
    else:
        ctx = got[key]
        unit = got.get("caches", {}).get("stack")
    assert tuple(ctx.shape) == (B, t_ctx, port_cfg.d_model)
    if unit is not None:
        last = unit[f"l{len(unit) - 1}"]
        assert last["cross"]["k"].dtype == torch.bfloat16
        assert last["attn"]["k"].dtype == (torch.int8 if kv_quant
                                           else torch.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_token_prompt_leaves_cross_attention_out(arch):
    """The reference's fault (ROADMAP C): ``gqa_apply`` takes its
    cross-*decode* branch whenever S == 1 and a cache is given, so a
    one-token prompt's prefill reads the fresh cross cache (every
    ``kpos`` -1), whose softmax is uniform over zeros: the cache is never
    filled and cross-attention adds 0 for the whole generation.  The
    port keeps the reference's result: the same logits (2e-4) a step,
    the cross cache left empty, and the logits the same whatever the
    context."""
    rb, pb, rp, pp = _pair(arch, remat=False)
    key, emb = _embeds(pb.cfg, 2)
    toks = _tokens(pb.cfg, 2, 4)
    runs = []
    for scale in (1.0, 3.0):
        wl, wc = rb.prefill_step(rp, {"tokens": jnp.asarray(toks[:, :1]),
                                      key: jnp.asarray(scale * emb),
                                      "caches": rb.make_cache(2, 8)})
        gl, gc = pb.prefill_step(pp, {
            "tokens": torch.from_numpy(toks[:, :1]),
            key: torch.from_numpy(scale * emb), "caches": pb.make_cache(2, 8)})
        logits = [(wl, gl)]
        for t in range(1, 4):
            wl, wc = rb.decode_step(rp, {
                "token": jnp.asarray(toks[:, t:t + 1]),
                "pos": jnp.full((2, 1), t, jnp.int32), "caches": wc})
            gl, gc = pb.decode_step(pp, {
                "token": torch.from_numpy(toks[:, t:t + 1]),
                "pos": torch.full((2, 1), t, dtype=torch.int32),
                "caches": gc})
            logits.append((wl, gl))
        for w, g in logits:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                       rtol=0)
        for c in (wc["layers"]["stack"]["l1"]["cross"],
                  to_numpy_tree(gc["layers"]["stack"]["l1"]["cross"])):
            assert np.all(np.asarray(c["kpos"]) == -1)
            assert not np.any(np.asarray(c["k"]))
        runs.append(torch.stack([g for _, g in logits]))
    assert torch.equal(runs[0], runs[1])
