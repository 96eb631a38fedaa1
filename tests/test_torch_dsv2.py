"""DeepSeek-V2 at its published widths in the port (``configs/
deepseek_v2_published.py``, the benchmark's ``dsv2-ep8-stage``), on the CPU
in fp32 at a small size with every new mechanism on — the q-lora query,
the latent's RMSNorm, YaRN, a dense width unlike ``d_ff``, 8 router
groups with the top 3 kept, gates scaled by 16, and an expert share —
against the benchmark's plain reference (``bench/reference/dsv2.py``):
the loss and every leaf's gradient, the expert shares adding up to the
uncut layer, the group limit, YaRN against a hand computation, prefill
and decode through the latent cache, the slot counter, and the
configurations that existed before left as they were."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.config import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import model_zoo
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import dsv2 as ref  # noqa: E402

# 16 experts in 8 groups of 2, the top 3 groups kept, top-4 within them
SMALL = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
             head_dim=16, d_ff=32, dense_d_ff=96, vocab_size=128,
             kv_lora_rank=16, q_lora_rank=24, qk_rope_dim=8,
             num_experts=16, num_shared_experts=2, experts_per_token=4,
             router_expert_groups=8, router_topk_groups=3,
             experts_held=4, experts_offset=0, dtype="float32")
NEW_FIELDS = ("q_lora_rank", "mla_kv_norm", "yarn_factor", "dense_d_ff",
              "router_expert_groups", "router_topk_groups",
              "router_norm_topk", "router_scale", "experts_held",
              "experts_offset")


def small(**kw) -> ArchConfig:
    return dataclasses.replace(configs.get("deepseek-v2-published"),
                               **{**SMALL, **kw})


def flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, prefix + k + ".")
        else:
            yield prefix + k, v


def layers_of(cfg):
    _, _, repeats = T.unit_pattern(cfg)
    return [(f"prefix.p{i}.", None) for i in range(cfg.first_dense_layers)
            ] + [("stack.l0.", r) for r in range(repeats)]


def batch(cfg, b=2, s=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g,
                         dtype=torch.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def spread_router(params, scale=4.0):
    """A router whose logits spread (std ≈ ``scale``), so top-k and the
    group choice sit far from ties."""
    for name, leaf in flatten(params):
        if name.endswith("router.w"):
            leaf.mul_(scale * math.sqrt(leaf.shape[0]))
    return params


def port_loss_and_grads(cfg, params, b):
    bundle = model_zoo.build(cfg, device="cpu")
    loss, grads = model_zoo.value_and_grad(bundle.loss_fn, params, b)
    return float(loss), dict(flatten(grads))


def ref_loss_and_grads(cfg, params, b):
    p = {n: v.detach().clone().requires_grad_() for n, v in flatten(params)}
    lv = ref.loss(p, b["tokens"], b["targets"], layers_of(cfg),
                  ref.Dims.of(cfg), torch.matmul)
    names = list(p)
    grads = torch.autograd.grad(lv, [p[n] for n in names])
    return float(lv.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("offset,capacity", [(0, 1.25), (4, 1.25),
                                             (12, 1.25), (0, 0.5)])
def test_loss_and_every_gradient_are_the_references(offset, capacity):
    cfg = small(experts_offset=offset, moe_capacity_factor=capacity)
    params = spread_router(T.init_model(cfg, torch.Generator().manual_seed(
        offset))[0])
    b = batch(cfg, seed=offset)
    got, gg = port_loss_and_grads(cfg, params, b)
    want, wg = ref_loss_and_grads(cfg, params, b)
    assert got == pytest.approx(want, rel=1e-5)
    assert set(gg) == set(wg)
    for name in wg:
        scale = float(wg[name].abs().max()) + 1e-12
        assert float((gg[name] - wg[name]).abs().max()) <= 2e-5 * scale, name


def test_the_tree_holds_the_published_parts():
    cfg = small()
    shapes = {n: tuple(v.shape) for n, v in flatten(
        T.init_model(cfg, None)[0])}
    H, q = cfg.num_heads, cfg.head_dim + cfg.qk_rope_dim
    assert shapes["prefix.p0.attn.q_a.w"] == (64, 24)
    assert shapes["prefix.p0.attn.q_norm.scale"] == (24,)
    assert shapes["prefix.p0.attn.q_b.w"] == (24, H * q)
    assert shapes["prefix.p0.attn.kv_norm.scale"] == (16,)
    assert "prefix.p0.attn.q.w" not in shapes
    assert shapes["prefix.p0.mlp.wi.w"] == (64, 96)          # dense width
    assert shapes["stack.l0.moe.router.w"] == (2, 64, 16)    # all experts
    assert shapes["stack.l0.moe.wi"] == (2, 4, 64, 32)       # those held
    assert shapes["stack.l0.moe.shared.wi.w"] == (2, 64, 64)
    total = sum(math.prod(s) for s in shapes.values())
    assert total == cfg.param_count()


def test_published_param_count_is_a_hand_count():
    """The whole published model: 235,741,434,880 parameters (embedding
    and head 2 × 102,400 × 5,120; a layer's MLA with q-lora and both
    norms; the dense layer's 3 × 5,120 × 12,288; 59 MoE layers of 162
    experts' 3 × 5,120 × 1,536 and a 5,120 × 160 router; two norms a
    layer and the final norm)."""
    cfg = configs.get("deepseek-v2-published")
    d, H = 5120, 128
    attn = d * 1536 + 1536 + 1536 * H * 192 + d * 576 + 512 + \
        512 * H * 256 + H * 128 * d
    moe = 162 * 3 * d * 1536 + d * 160
    want = 2 * 102400 * d + 60 * (attn + 2 * d) + 3 * d * 12288 + \
        59 * moe + d
    assert cfg.param_count() == want == 235_741_434_880


def test_the_shares_add_up_to_the_uncut_layer():
    """8 devices of 2 experts each: their layers' outputs, with the shared
    experts (which every device computes alike) counted once, are the
    uncut reference layer's."""
    cfg = small(experts_held=0, moe_capacity_factor=0.75)
    g = torch.Generator().manual_seed(3)
    p, _ = MOE.moe_init(g, cfg, torch.float32)
    p["router"]["w"].mul_(4.0 * math.sqrt(cfg.d_model))
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    flat = {"l.moe." + n: v for n, v in flatten(p)}
    uncut = ref.moe(x, flat, "l.", ref.Dims.of(cfg), torch.matmul)
    shared = L.mlp_apply(p["shared"], x, L.ModelCtx(cfg=cfg,
                                                    dtype=torch.float32))
    total = torch.zeros_like(x)
    for dev in range(8):
        part = small(experts_held=2, experts_offset=2 * dev,
                     moe_capacity_factor=0.75)
        q = dict(p, **{k: p[k][2 * dev:2 * dev + 2] for k in
                       ("wi", "wg", "wo")})
        total = total + MOE.moe_apply(q, x, L.ModelCtx(
            cfg=part, dtype=torch.float32)) - shared
    torch.testing.assert_close(total + shared, uncut, rtol=1e-5, atol=1e-5)
    whole = MOE.moe_apply(p, x, L.ModelCtx(cfg=cfg, dtype=torch.float32))
    torch.testing.assert_close(whole, uncut, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups,top", [(8, 3), (4, 1), (8, 8)])
def test_no_token_routes_past_its_top_groups(groups, top):
    cfg = small(router_expert_groups=groups, router_topk_groups=top)
    g = torch.Generator().manual_seed(groups * 10 + top)
    probs = torch.softmax(3.0 * torch.randn(2, 64, 16, generator=g), -1)
    gate, eidx = MOE._select(probs, 4, cfg)
    per = 16 // groups
    for row in (eidx // per).reshape(-1, 4).tolist():
        assert len(set(row)) <= top
    # the gates are the chosen experts' probabilities times 16, and the
    # chosen experts are the reference's
    torch.testing.assert_close(gate, 16.0 * torch.gather(probs, -1, eidx))
    want_gate, want_e = ref.route(probs.reshape(-1, 16), ref.Dims.of(cfg))
    assert torch.equal(eidx.reshape(-1, 4), want_e)
    torch.testing.assert_close(gate.reshape(-1, 4), want_gate)


def test_the_router_defaults_are_plain_topk_renormalised():
    cfg = configs.smoke_variant(configs.get("deepseek-v2-236b"))
    probs = torch.softmax(torch.randn(1, 32, cfg.num_experts,
                                      generator=torch.Generator()
                                      .manual_seed(0)), -1)
    gate, eidx = MOE._select(probs, cfg.experts_per_token, cfg)
    top, idx = torch.topk(probs, cfg.experts_per_token, -1)
    assert torch.equal(eidx, idx)
    torch.testing.assert_close(gate, top / top.sum(-1, keepdim=True))
    assert torch.equal(gate, MOE._select(probs, cfg.experts_per_token)[0])


def test_yarn_is_a_hand_computation_at_factor_40():
    """DeepSeek-V2's rope_scaling over its 64 rotary dims: the ramp runs
    from pair 10 (32 turns over 4,096 positions) to pair 23 (1 turn);
    below it the frequencies are theta^(-i/32), above it divided by 40;
    cos/sin keep scale 1 (mscale = mscale_all_dim); the softmax scale is
    192^-1/2 × (1 + 0.1 × 0.707 × ln 40)^2."""
    cfg = configs.get("deepseek-v2-published")
    yarn = L.Yarn.of(cfg)
    low = math.floor(64 * math.log(4096 / (32 * 2 * math.pi))
                     / (2 * math.log(10000)))
    high = math.ceil(64 * math.log(4096 / (2 * math.pi))
                     / (2 * math.log(10000)))
    assert (low, high) == (10, 23) == yarn.band(64, 10000.0)
    got = yarn.inv_freq(32, 10000.0, "cpu").double()
    for i in range(32):
        base = 10000.0 ** (-i / 32)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want = base / 40 * ramp + base * (1 - ramp)
        assert float(got[i]) == pytest.approx(want, rel=1e-6), i
    assert yarn.cos_scale == 1.0
    m = 1 + 0.1 * 0.707 * math.log(40)
    assert L.mla_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert L.mla_scale(cfg) == pytest.approx(192 ** -0.5 * 1.5896, rel=1e-4)
    ref_dims = ref.Dims.of(cfg)
    torch.testing.assert_close(ref.inv_freq(ref_dims, "cpu"),
                               got.float(), rtol=1e-6, atol=0)
    assert ref.softmax_scale(ref_dims) == pytest.approx(L.mla_scale(cfg))


def test_yarn_scales_cos_and_sin_by_the_mscale_ratio():
    cfg = small(yarn_mscale=1.0, yarn_mscale_all_dim=0.5)
    yarn = L.Yarn.of(cfg)
    want = (0.1 * math.log(40) + 1) / (0.05 * math.log(40) + 1)
    assert yarn.cos_scale == pytest.approx(want)
    x = torch.randn(1, 5, 2, 8, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(5)[None]
    got = L.rope(x, pos, 10000.0, yarn=yarn)
    torch.testing.assert_close(got, ref.rope(x[0], pos[0], ref.Dims.of(cfg))
                               [None], rtol=1e-5, atol=1e-6)
    plain = L.rope(x, pos, 10000.0)
    assert not torch.allclose(got, plain)


def test_prefill_then_decode_through_the_latent_cache():
    """At a drop-free capacity (a token's routing is then its own), the
    prompt's prefill and 4 decode steps through the normalised latent
    cache give the full forward's logits."""
    cfg = small(moe_capacity_factor=64.0)
    bundle = model_zoo.build(cfg, device="cpu")
    params = spread_router(bundle.init(5)[0])
    toks = batch(cfg, b=2, s=12, seed=5)["tokens"]
    with torch.no_grad():
        h, _ = T.forward_hidden(params, cfg, toks, bundle.ctx)
        full = T.logits_from_hidden(params, cfg, h)
    prompt = 8
    logits, caches = bundle.prefill_step(params, {
        "tokens": toks[:, :prompt], "caches": bundle.make_cache(2, 16)})
    torch.testing.assert_close(logits, full[:, prompt - 1], rtol=1e-4,
                               atol=1e-4)
    for t in range(prompt, 12):
        logits, caches = bundle.decode_step(params, {
            "token": toks[:, t:t + 1], "pos": torch.full((2, 1), t,
                                                         dtype=torch.int32),
            "caches": caches})
        torch.testing.assert_close(logits, full[:, t], rtol=1e-4, atol=1e-4)
    ckv = caches["layers"]["prefix"][0]["attn"]["ckv"]
    rms = ckv[:, :12].pow(2).mean(-1).sqrt()        # the normalised latent
    torch.testing.assert_close(rms, torch.ones_like(rms), rtol=1e-4,
                               atol=1e-4)


def test_the_slot_counter_counts_each_forward_once():
    """Under remat the MoE layers run again in the backward; the counter
    adds their routed and dropped slots once, as the reference routes
    them."""
    cfg = small(moe_capacity_factor=0.75)
    params = spread_router(T.init_model(cfg, torch.Generator().manual_seed(
        7))[0])
    b = batch(cfg, seed=7)
    MOE.slot_counts.reset()
    MOE.slot_counts.on = True
    try:
        port_loss_and_grads(cfg, params, b)
        routed, dropped = MOE.slot_counts.read()
    finally:
        MOE.slot_counts.on = False
        MOE.slot_counts.reset()
    dims = ref.Dims.of(cfg)
    want_r = want_d = 0
    p = dict(flatten(params))
    x = p["embed.w"][b["tokens"].long()]
    for pre, index in layers_of(cfg):
        lp = {n: (v if index is None else v[index]) for n, v in p.items()
              if n.startswith(pre)}
        if pre + "moe.router.w" in lp:
            z = ref.rmsnorm(x + ref.mla(ref.rmsnorm(
                x, lp[pre + "norm1.scale"], dims.eps), lp, pre, dims,
                torch.matmul), lp[pre + "norm2.scale"], dims.eps)
            probs = torch.softmax(z.reshape(-1, cfg.d_model)
                                  @ lp[pre + "moe.router.w"], -1)
            _, e = ref.route(probs, dims)
            cap = ref.capacity(dims, probs.shape[0])
            for ex in range(dims.offset, dims.offset + dims.held):
                n = int((e == ex).sum())
                want_r += n
                want_d += max(0, n - cap)
        x = ref.block(x, lp, pre, dims, torch.matmul)
    assert (routed, dropped) == (want_r, want_d)
    assert dropped > 0


def test_the_step_runs_and_its_spans_stay_off_the_log():
    from repro_torch.config import ScbfConfig
    from repro_torch.core import distributed as dist
    from repro_torch.obs import trace
    cfg = small(dtype="bfloat16")
    bundle = model_zoo.build(cfg, device="cpu")
    params = bundle.init(1)[0]
    b = {k: torch.stack([v, v.flip(0)]) for k, v in batch(cfg).items()}
    step = dist.make_federated_train_step(
        bundle.loss_fn, ScbfConfig(upload_rate=0.1, num_clients=2))
    with trace.recording() as rec:
        loss, new = step(params, b)
    assert math.isfinite(float(loss))
    assert not [e for e in rec.events if e["ev"] == "span"]
    moved = [n for (n, a), (_, c) in zip(flatten(params), flatten(new))
             if not torch.equal(a, c)]
    assert {"prefix.p0.attn.q_a.w", "prefix.p0.attn.kv_down.w"} <= set(moved)


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_the_assigned_configs_keep_every_new_field_off(arch):
    cfg = configs.get(arch)
    defaults = ArchConfig(name="x", family="x", source="x")
    for f in NEW_FIELDS + ("yarn_original_len", "yarn_beta_fast",
                           "yarn_beta_slow", "yarn_mscale",
                           "yarn_mscale_all_dim"):
        assert getattr(cfg, f) == getattr(defaults, f), f
    assert cfg.held_experts == cfg.num_experts
    assert L.Yarn.of(cfg) is None
    if cfg.use_mla:
        assert L.mla_scale(cfg) == (cfg.head_dim + cfg.qk_rope_dim) ** -0.5
    smoke = configs.smoke_variant(cfg)
    for f in NEW_FIELDS:
        assert getattr(smoke, f) == getattr(defaults, f), f


def test_deepseek_v2_236b_builds_and_runs_as_before():
    """The assigned spec keeps one dense q projection, no latent norm, one
    width for every MLP and all its experts; its loss runs."""
    cfg = dataclasses.replace(configs.smoke_variant(configs.get(
        "deepseek-v2-236b")), dtype="float32")
    shapes = {n: tuple(v.shape) for n, v in flatten(
        T.init_model(cfg, None)[0])}
    assert not [n for n in shapes if "q_a" in n or "norm." in n and
                "attn" in n]
    assert shapes["prefix.p0.attn.q.w"] == (cfg.d_model, cfg.num_heads * (
        cfg.head_dim + cfg.qk_rope_dim))
    assert shapes["prefix.p0.mlp.wi.w"] == (cfg.d_model, cfg.d_ff)
    assert shapes["stack.l0.moe.wi"][1] == cfg.num_experts
    bundle = model_zoo.build(cfg, device="cpu")
    loss = bundle.loss_fn(bundle.init(0)[0], batch(cfg))
    assert math.isfinite(float(loss))
