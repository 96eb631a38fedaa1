"""The port's LM zoo (``repro_torch.models``: transformer and model_zoo,
``configs``) against the reference's on the CPU — the dense models, the
MoE ones (deepseek-v2 with MLA, llama4-maverick) and the SSM ones
(mamba2, the jamba hybrid) — with the
reference's initial params carried across (``params.from_numpy_tree``):
param trees equal in paths, shapes and dtypes; losses within 1e-5 in fp32
and 2e-2 relative in bf16; prefill and decode logits within 2e-4 in fp32
with equal greedy tokens."""
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

DENSE = [n for n in ref_configs.ASSIGNED
         if ref_configs.get(n).family == "dense"]
MOE = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]
SSM = ["mamba2-2.7b", "jamba-1.5-large-398b"]
OTHERS = [n for n in ref_configs.ASSIGNED if n not in DENSE + MOE + SSM]
# the reference's smoke tests route MoE without drops when they compare a
# decode with a cache-less forward (tests/test_models_smoke.py)
NO_DROPS = {"moe_capacity_factor": 8.0}


def _cfgs(arch, **kw):
    return (dataclasses.replace(
                ref_configs.smoke_variant(ref_configs.get(arch)), **kw),
            dataclasses.replace(
                port_configs.smoke_variant(port_configs.get(arch)), **kw))


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p),
             tuple(leaf.shape), np.dtype(leaf.dtype).name)
            for p, leaf in flat]


def _port_paths(tree):
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_paths(tree)]


def _pair(arch, dtype="float32", cfg_kw=None, **build_kw):
    """(ref bundle, port bundle, ref params, the same params in torch)."""
    ref_cfg, port_cfg = _cfgs(arch, dtype=dtype, **(cfg_kw or {}))
    rb = ref_zoo.build(ref_cfg, **build_kw)
    pb = port_zoo.build(port_cfg, device="cpu", **build_kw)
    rp, _ = rb.init(jax.random.PRNGKey(0))
    return rb, pb, rp, from_numpy_tree(jax.tree_util.tree_map(np.asarray,
                                                              rp), "cpu")


def _has_moe(arch) -> bool:
    return bool(port_configs.get(arch).num_experts)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


# the port's own configs (DeepSeek-V2 as published, whose fields the JAX
# package's ArchConfig lacks) and the port's own fields, each left at its
# default by every config the two packages share
PORT_ONLY = {"deepseek-v2-published"}


def _as_reference(port) -> dict:
    """A port ArchConfig's fields that the reference's has; the others
    must sit at their defaults."""
    ref_fields = {f.name for f in dataclasses.fields(ref_configs.ArchConfig)}
    out = dataclasses.asdict(port)
    for f in dataclasses.fields(port):
        if f.name not in ref_fields:
            assert out.pop(f.name) == f.default, f.name
    return out


def test_configs_are_the_references():
    assert sorted(port_configs.ARCHS) == sorted(
        set(ref_configs.ARCHS) | PORT_ONLY)
    assert port_configs.ASSIGNED == ref_configs.ASSIGNED
    for name, ref in ref_configs.ARCHS.items():
        port = port_configs.get(name)
        assert _as_reference(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert _as_reference(port_configs.smoke_variant(port)) == \
            dataclasses.asdict(ref_configs.smoke_variant(ref))
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}
    with pytest.raises(KeyError):
        port_configs.get("gpt-5")


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
def test_param_tree_is_the_references(arch):
    """Paths, shapes and dtypes of the smoke variant's params and axes,
    in flatten order (the stacked layer leaves included)."""
    ref_cfg, port_cfg = _cfgs(arch)
    rp, ra = ref_zoo.build(ref_cfg).init(jax.random.PRNGKey(0))
    pp, pa = port_zoo.build(port_cfg, device="cpu").init(0)
    assert _port_paths(pp) == _ref_paths(rp)
    assert [leaf for _, leaf in tree_paths(pa)] == \
        jax.tree_util.tree_leaves(ra)


def test_full_width_qwen2_shapes_on_meta():
    """qwen2-0.5b at full width: the port's init on the meta device
    against the reference's ``jax.eval_shape``; 15 leaves, 14 of them
    scored (ndim >= 2), and the parameter count."""
    ref_cfg, port_cfg = ref_configs.get("qwen2-0.5b"), \
        port_configs.get("qwen2-0.5b")
    shapes = jax.eval_shape(
        lambda k: ref_zoo.build(ref_cfg).init(k)[0], jax.random.PRNGKey(0))
    params, _ = PT.init_model(port_cfg, None)
    assert _port_paths(params) == _ref_paths(shapes)
    leaves = tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert len(leaves) == 15 and sum(t.ndim >= 2 for t in leaves) == 14
    assert sum(t.numel() for t in leaves) == port_cfg.param_count() == \
        ref_cfg.param_count() == 630_167_424


@pytest.mark.parametrize("arch,depth,params,leaves,scored", [
    ("deepseek-v2-236b", 2, 5_353_956_352, 25, 22),
    ("llama4-maverick-400b-a17b", 2, 18_553_267_200, 25, 24),
])
def test_full_width_moe_shapes_on_meta(arch, depth, params, leaves, scored):
    """The MoE models at full width, cut to one period of their layer
    pattern (deepseek-v2: the dense prefix layer and one MoE layer;
    llama4: [dense, moe]), on the meta device against the reference's
    ``jax.eval_shape``: the tree, the parameter count, the scored leaves
    (ndim >= 2) and the one fp32 leaf, the router."""
    ref_cfg = dataclasses.replace(ref_configs.get(arch), num_layers=depth)
    port_cfg = dataclasses.replace(port_configs.get(arch), num_layers=depth)
    shapes = jax.eval_shape(
        lambda k: ref_zoo.build(ref_cfg).init(k)[0], jax.random.PRNGKey(0))
    tree, _ = PT.init_model(port_cfg, None)
    assert _port_paths(tree) == _ref_paths(shapes)
    got = tree_paths(tree)
    assert len(got) == leaves and sum(t.ndim >= 2 for _, t in got) == scored
    assert [p for p, t in got if t.dtype == torch.float32] == [
        ("stack", "l0" if arch.startswith("deepseek") else "l1", "moe",
         "router", "w")]
    assert sum(t.numel() for _, t in got) == port_cfg.param_count() == \
        ref_cfg.param_count() == params


@pytest.mark.parametrize("arch,depth,experts,params,fp32", [
    ("mamba2-2.7b", 64, 0, 2_830_624_256, 2),
    ("jamba-1.5-large-398b", 72, 16, 397_709_859_072, 4 + 2 * 7),
    ("jamba-1.5-large-398b", 8, 16, 45_144_428_800, 4 + 2 * 7),
    ("jamba-1.5-large-398b", 8, 8, 25_816_813_824, 4 + 2 * 7),
])
def test_full_width_ssm_shapes_on_meta(arch, depth, experts, params, fp32):
    """mamba2-2.7b uncut and jamba at every published width (its whole
    depth, one period of 8 layers, and that period with 8 of its 16
    experts: what the card runs) on the meta device against the
    reference's ``jax.eval_shape``: the tree, its parameter count, and the
    fp32 leaves — ``A_log`` and ``D_res`` of each Mamba layer of the unit,
    stacked, and each MoE router.  ``param_count()``, the reference's
    closed form (the port's is the same), counts two norms a layer and no
    ``in_dt`` bias: a Mamba layer without an MLP (mamba2) holds d_model -
    NH params fewer than it counts, one with an MLP (jamba's) NH more."""
    kw = dict(num_layers=depth)
    if experts:
        kw["num_experts"] = experts
    ref_cfg = dataclasses.replace(ref_configs.get(arch), **kw)
    port_cfg = dataclasses.replace(port_configs.get(arch), **kw)
    shapes = jax.eval_shape(
        lambda k: ref_zoo.build(ref_cfg).init(k)[0], jax.random.PRNGKey(0))
    tree, _ = PT.init_model(port_cfg, None)
    assert _port_paths(tree) == _ref_paths(shapes)
    got = tree_paths(tree)
    f32 = [p for p, t in got if t.dtype == torch.float32]
    assert len(f32) == fp32 and all(
        p[-1] in ("A_log", "D_res") or p[-2:] == ("router", "w") for p in f32)
    n = sum(t.numel() for _, t in got)
    assert n == sum(math.prod(a.shape) for a in
                    jax.tree_util.tree_leaves(shapes)) == params
    mamba_layers = sum(not port_cfg._is_attn_layer(i) for i in range(depth))
    per_layer = port_cfg.num_ssm_heads - (0 if port_cfg.d_ff
                                          else port_cfg.d_model)
    assert port_cfg.param_count() == ref_cfg.param_count() == \
        n - mamba_layers * per_layer


@pytest.mark.parametrize("arch", ["qwen2-0.5b"] + MOE + SSM)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_input_specs_are_the_references(arch, shape, kv_quant):
    """Batches and cache trees at the assigned shapes (MLA's latent cache
    whether or not ``kv_quant`` is asked)."""
    ref_cfg, port_cfg = ref_configs.get(arch), port_configs.get(arch)
    want = ref_zoo.build(ref_cfg, kv_quant=kv_quant).input_specs(
        REF_SHAPES[shape])
    got = port_zoo.build(port_cfg, device="cpu", kv_quant=kv_quant
                         ).input_specs(INPUT_SHAPES[shape])
    assert _port_paths(got) == _ref_paths(want)
    assert all(t.device.type == "meta" for t in tree_leaves(got))


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_loss_fn(arch, dtype, rtol):
    rb, pb, rp, pp = _pair(arch, dtype)
    toks, tgts = _tokens(pb.cfg, 2, 16), _tokens(pb.cfg, 2, 16, seed=2)
    want = float(rb.loss_fn(rp, {"tokens": jnp.asarray(toks),
                                 "targets": jnp.asarray(tgts)}))
    got = float(pb.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                                "targets": torch.from_numpy(tgts)}))
    assert got == pytest.approx(want, rel=rtol, abs=rtol)


def test_train_step_fp32():
    """One SGD step: loss and every updated leaf within 1e-5; the params
    handed in are left as they were."""
    rb, pb, rp, pp = _pair("qwen2-0.5b")
    before = [t.clone() for t in tree_leaves(pp)]
    toks, tgts = _tokens(pb.cfg, 2, 16), _tokens(pb.cfg, 2, 16, seed=2)
    wl, wp = rb.train_step(rp, {"tokens": jnp.asarray(toks),
                                "targets": jnp.asarray(tgts)}, 0.1)
    gl, gp = pb.train_step(pp, {"tokens": torch.from_numpy(toks),
                                "targets": torch.from_numpy(tgts)}, 0.1)
    assert float(gl) == pytest.approx(float(wl), rel=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(wp),
                    tree_leaves(to_numpy_tree(gp))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) and not b.requires_grad
               for a, b in zip(before, tree_leaves(pp)))


@pytest.mark.parametrize("arch", SSM)
def test_ssm_logits_loss_and_gradients(arch):
    """mamba2 and jamba (MoE at the published capacity) in fp32 with the
    reference's weights: logits, loss and the gradient of every leaf within
    1e-5, over 2 chunks of 16."""
    rb, pb, rp, pp = _pair(arch)
    toks, tgts = _tokens(pb.cfg, 2, 32), _tokens(pb.cfg, 2, 32, seed=2)
    rh, _ = RT.forward_hidden(rp, rb.cfg, jnp.asarray(toks), rb.ctx)
    ph, _ = PT.forward_hidden(pp, pb.cfg, torch.from_numpy(toks), pb.ctx)
    np.testing.assert_allclose(
        PT.logits_from_hidden(pp, pb.cfg, ph).detach().numpy(),
        np.asarray(RT.logits_from_hidden(rp, rb.cfg, rh)), rtol=1e-5,
        atol=1e-5)
    wl, wg = jax.value_and_grad(rb.loss_fn)(
        rp, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    gl, gg = port_zoo.value_and_grad(pb.loss_fn, pp, {
        "tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)})
    assert float(gl) == pytest.approx(float(wl), rel=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(wg), tree_leaves(gg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


def test_remat_changes_no_gradient():
    """``remat`` (``torch.utils.checkpoint`` over each unit) gives the
    same loss and gradients, bitwise."""
    _, port_cfg = _cfgs("qwen2-0.5b", dtype="float32")
    outs = []
    for remat in (False, True):
        pb = port_zoo.build(port_cfg, remat=remat, device="cpu")
        params, _ = pb.init(0)
        toks = torch.from_numpy(_tokens(port_cfg, 2, 16))
        outs.append(port_zoo.value_and_grad(
            pb.loss_fn, params, {"tokens": toks, "targets": toks}))
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


@pytest.mark.parametrize("arch,kv_quant", [(a, False) for a in
                                           DENSE + MOE + SSM]
                         + [("qwen2-0.5b", True), ("deepseek-v2-236b", True)])
def test_prefill_then_decode(arch, kv_quant):
    """Prefill 8 tokens into fresh caches of 10 slots, then 4 decode steps
    (the ring wraps at position 10): logits within 2e-4 of the
    reference's, greedy tokens equal, and (without int8, before the wrap)
    the port's own cache-less forward within 2e-4 (MoE without drops, as
    the reference's smoke test; MLA's latent cache is not quantized; a
    Mamba layer's prefill runs one chunk of 8 and its decode the O(1)
    recurrence)."""
    rb, pb, rp, pp = _pair(arch, kv_quant=kv_quant, remat=False,
                           cfg_kw=NO_DROPS if _has_moe(arch) else None)
    toks = _tokens(pb.cfg, 2, 12)
    wl, wc = rb.prefill_step(rp, {"tokens": jnp.asarray(toks[:, :8]),
                                  "caches": rb.make_cache(2, 10)})
    gl, gc = pb.prefill_step(pp, {"tokens": torch.from_numpy(toks[:, :8]),
                                  "caches": pb.make_cache(2, 10)})
    h, _ = PT.forward_hidden(pp, pb.cfg, torch.from_numpy(toks), pb.ctx)
    full = PT.logits_from_hidden(pp, pb.cfg, h).detach()
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
        if (not kv_quant or pb.cfg.use_mla) and t < 10:
            np.testing.assert_allclose(g.numpy(), full[:, t].numpy(),
                                       atol=2e-4, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-236b"])
def test_query_chunked_prefill(arch):
    """A prefill of 16 tokens at ``q_chunk`` 8 takes the chunked path (GQA,
    or MLA's) and gives the reference's logits and caches."""
    rb, pb, rp, pp = _pair(arch, q_chunk=8, remat=False)
    toks = _tokens(pb.cfg, 2, 16)
    wl, wc = rb.prefill_step(rp, {"tokens": jnp.asarray(toks),
                                  "caches": rb.make_cache(2, 16)})
    gl, gc = pb.prefill_step(pp, {"tokens": torch.from_numpy(toks),
                                  "caches": pb.make_cache(2, 16)})
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=2e-4,
                               rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(wc),
                    tree_leaves(to_numpy_tree(gc))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=1e-5)


def test_sliding_window_decode_matches_windowed_forward():
    """The reference's ring-buffer test on the port: decode token by token
    with a cache of ``window`` slots reproduces the windowed full forward
    (and the reference's windowed forward)."""
    rb, pb, rp, pp = _pair("qwen2-0.5b", remat=False)
    toks = _tokens(pb.cfg, 1, 12)
    window = 4
    h, _ = PT.forward_hidden(pp, pb.cfg, torch.from_numpy(toks), pb.ctx,
                             window=window)
    full = PT.logits_from_hidden(pp, pb.cfg, h).detach()
    rh, _ = RT.forward_hidden(rp, rb.cfg, jnp.asarray(toks), rb.ctx,
                              window=window)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(RT.logits_from_hidden(rp, rb.cfg, rh)),
        atol=2e-4, rtol=0)
    caches = {"layers": pb.make_cache(1, window)}
    for t in range(12):
        lg, caches = pb.decode_step(pp, {
            "token": torch.from_numpy(toks[:, t:t + 1]),
            "pos": torch.full((1, 1), t, dtype=torch.int32),
            "caches": caches}, window=window)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   atol=2e-4, rtol=0)


def test_prefix_layers_forward_like_the_reference():
    """A dense config with one unrolled prefix layer (the reference's
    ``first_dense_layers``): the same param tree and loss."""
    ref_cfg, port_cfg = _cfgs("qwen2-0.5b", dtype="float32",
                              first_dense_layers=1)
    rb, pb = ref_zoo.build(ref_cfg), port_zoo.build(port_cfg, device="cpu")
    rp, _ = rb.init(jax.random.PRNGKey(0))
    pp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    assert _port_paths(pb.init(0)[0]) == _ref_paths(rp)
    toks = _tokens(port_cfg, 2, 8)
    want = float(rb.loss_fn(rp, {"tokens": jnp.asarray(toks),
                                 "targets": jnp.asarray(toks)}))
    got = float(pb.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                                "targets": torch.from_numpy(toks)}))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_capacity_and_groups_through_build(arch, groups):
    """``build(moe_groups=)`` routes as the reference's, at the published
    capacity factor (1.25, where 2 x 16 tokens may drop), loss and
    gradients: the loss within 1e-5 and one SGD step's params too;
    ``moe_dshard`` changes nothing on one device."""
    rb, pb, rp, pp = _pair(arch, moe_groups=groups)
    toks, tgts = _tokens(pb.cfg, 2, 16), _tokens(pb.cfg, 2, 16, seed=2)
    wl, wp = rb.train_step(rp, {"tokens": jnp.asarray(toks),
                                "targets": jnp.asarray(tgts)}, 0.1)
    gl, gp = pb.train_step(pp, {"tokens": torch.from_numpy(toks),
                                "targets": torch.from_numpy(tgts)}, 0.1)
    assert float(gl) == pytest.approx(float(wl), rel=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(wp),
                    tree_leaves(to_numpy_tree(gp))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-5)
    shard = port_zoo.build(pb.cfg, moe_groups=groups, moe_dshard=True,
                           device="cpu")
    assert torch.equal(
        shard.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                           "targets": torch.from_numpy(tgts)}), gl)


@pytest.mark.parametrize("arch", MOE)
def test_from_numpy_tree_keeps_each_leafs_dtype(arch):
    """The reference's bf16 MoE tree carried across: every leaf keeps its
    dtype (the fp32 router stays fp32) and its values, exactly."""
    ref_cfg, _ = _cfgs(arch, dtype="bfloat16")
    rp, _ = ref_zoo.build(ref_cfg).init(jax.random.PRNGKey(0))
    tree = from_numpy_tree(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    want = jax.tree_util.tree_leaves(rp)
    got = tree_leaves(tree)
    assert [np.dtype(a.dtype).name for a in want] == \
        [str(t.dtype).replace("torch.", "") for t in got]
    assert sum(t.dtype == torch.float32 for t in got) == 1
    for a, t in zip(want, tree_leaves(to_numpy_tree(tree))):
        assert np.array_equal(np.asarray(a, np.float32), t)


@pytest.mark.parametrize("arch", OTHERS)
def test_build_accepts_the_encoder_and_cross_archs(arch):
    """whisper-medium (the encoder) and llama-3.2-vision-11b
    (cross-attention) as published build with no refusal; each cross
    layer's cache holds the context's K/V (R, B, t_ctx, KV, hd) — t_ctx
    whisper's 1500 frames or the 1024 patch tokens — in the model dtype,
    and its positions (R, B, t_ctx) int32; ``context_input`` names the
    batch key and the tokens of that context."""
    cfg = port_configs.get(arch)
    bundle = port_zoo.build(cfg, device="cpu")
    caches = bundle.input_specs(INPUT_SHAPES["decode_32k"])["caches"]
    unit = caches["layers"]["stack"]
    cross = unit[f"l{cfg.cross_attn_every - 1}"]["cross"]
    R = cfg.num_layers // cfg.cross_attn_every
    B = INPUT_SHAPES["decode_32k"].global_batch
    t_ctx = cfg.encoder_seq if cfg.encoder_layers else cfg.num_patch_tokens
    assert port_zoo.context_input(cfg) == (
        "audio_embeds" if cfg.encoder_layers else "image_embeds", t_ctx)
    assert t_ctx == (1500 if arch == "whisper-medium" else 1024)
    for name in ("k", "v"):
        assert tuple(cross[name].shape) == (R, B, t_ctx, cfg.num_kv_heads,
                                            cfg.head_dim)
        assert cross[name].dtype == torch.bfloat16
    assert tuple(cross["kpos"].shape) == (R, B, t_ctx)
    assert cross["kpos"].dtype == torch.int32
    assert sum("cross" in unit[k] for k in unit) == 1


@pytest.mark.parametrize("arch", SSM)
def test_build_accepts_the_ssm_archs(arch):
    """mamba2-2.7b and jamba-1.5-large-398b as published build with no
    refusal; their cache trees hold each Mamba layer's fp32 state
    ``h`` (B, NH, N, P) and its conv window (B, W-1, DI+2N); they read
    no context."""
    cfg = port_configs.get(arch)
    bundle = port_zoo.build(cfg, device="cpu")
    assert port_zoo.context_input(cfg) is None
    caches = bundle.input_specs(INPUT_SHAPES["decode_32k"])["caches"]
    mamba = caches["layers"]["stack"]["l0"]["mamba"]
    R = cfg.num_layers // (8 if cfg.family == "hybrid" else 1)
    B = INPUT_SHAPES["decode_32k"].global_batch
    assert tuple(mamba["h"].shape) == (R, B, cfg.num_ssm_heads,
                                       cfg.ssm_state, cfg.ssm_head_dim)
    assert mamba["h"].dtype == torch.float32
    assert tuple(mamba["conv"].shape) == (R, B, cfg.ssm_conv_width - 1,
                                          cfg.d_inner + 2 * cfg.ssm_state)
    assert mamba["conv"].dtype == torch.bfloat16


def test_build_needs_cuda_unless_cpu_is_asked():
    _, port_cfg = _cfgs("qwen2-0.5b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_zoo.build(port_cfg)


def test_init_draws_from_the_generator():
    """Seeded init is reproducible and differs between seeds; weights are
    truncated at two standard deviations of their fan-in scale."""
    _, port_cfg = _cfgs("qwen2-0.5b", dtype="float32")
    pb = port_zoo.build(port_cfg, device="cpu")
    a, b, c = pb.init(0)[0], pb.init(0)[0], pb.init(1)[0]
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not torch.equal(a["embed"]["w"], c["embed"]["w"])
    w = a["stack"]["l0"]["mlp"]["wi"]["w"]
    assert float(w.abs().max()) <= 2.0 / port_cfg.d_model ** 0.5 + 1e-6
    assert float(w.std()) == pytest.approx(
        0.88 / port_cfg.d_model ** 0.5, rel=0.05)


def test_a_large_leaf_is_drawn_in_chunks(monkeypatch):
    """A leaf of more than ``DRAW_CHUNK`` entries (an MoE expert stack at
    full width) is drawn ``DRAW_CHUNK`` entries at a time in flat order:
    the same numbers as drawing the chunks one after another, truncated
    at two standard deviations; a smaller leaf is drawn at once, as
    before."""
    from repro_torch.models import common

    monkeypatch.setattr(common, "DRAW_CHUNK", 1000)
    got = common.trunc_normal(torch.Generator().manual_seed(3), (50, 60),
                              0.5, torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    want = torch.cat([common._trunc_normal_draw(gen, (1000,), 0.5,
                                                torch.bfloat16)
                      for _ in range(3)]).view(50, 60)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert float(got.abs().max()) <= 1.0
    small = common.trunc_normal(torch.Generator().manual_seed(3), (20, 50),
                                0.5, torch.float32)
    assert torch.equal(small, common._trunc_normal_draw(
        torch.Generator().manual_seed(3), (20, 50), 0.5, torch.float32))
