"""SCBF's federated LM step on the port (``repro_torch.core.distributed``,
the factored channel scores of ``repro_torch.core.channels`` and
``repro_torch.data.tokens``) against the reference on the CPU, where the
channel-norm (K1) and select-mask (K2) wrappers take their plain
versions.  Tolerances: scores rtol 1e-6; masks and uploaded fractions
bitwise given the reference's scores and threshold (ties at the
threshold and a -inf threshold included); the federated step's loss and
params within 1e-5 in fp32 and its update within 5e-5 of the reference's
update, relative (bf16: loss 2e-2 relative, params within two bf16 ulps
of 1.0, update 0.25 relative)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.config import ScbfConfig as RefScbf
from repro.core import channels as ref_ch
from repro.core import distributed as ref_dist
from repro.data import tokens as ref_tokens
from repro.models import model_zoo as ref_zoo
from repro_torch import configs as port_configs
from repro_torch.config import ScbfConfig
from repro_torch.core import channels as port_ch
from repro_torch.core import distributed as port_dist
from repro_torch.data import tokens as port_tokens
from repro_torch.kernels import channel_norm as cn
from repro_torch.kernels import select_mask as sm
from repro_torch.models import model_zoo as port_zoo
from repro_torch.params import (from_numpy_tree, to_numpy_tree, tree_leaves,
                                tree_paths, tree_unflatten)


def _grad_tree(rng, dtype=np.float32):
    """A gradient tree shaped like a stacked LM's: matrices, a stacked
    3-D leaf, stacked (R, N) biases and 1-D scales; 141 scored channels,
    so the quantile's position 140·q is an integer at q = 0.1, 0.5, 0.75
    and the threshold is one of the scores."""
    tree = {"embed": {"w": rng.normal(size=(40, 16))},
            "stack": {"l0": {"attn": {"q": {"b": rng.normal(size=(3, 24)),
                                            "w": rng.normal(size=(3, 16, 24))},
                                      "o": {"w": rng.normal(size=(3, 24, 16))}},
                             "norm1": {"scale": rng.normal(size=(3, 16))}}},
            "final_norm": {"scale": rng.normal(size=(16,))},
            "unembed": {"w": rng.normal(size=(16, 45))}}
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_factored_scores(dtype):
    rng = np.random.default_rng(0)
    tree = _grad_tree(rng)
    ref_tree = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.dtype(dtype)), tree)
    _, want = ref_ch.factored_scores(ref_tree)
    leaves, got = port_ch.factored_scores(
        from_numpy_tree(_np(ref_tree), "cpu"))
    assert len(leaves) == len(want)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("rate,selection", [(0.25, "positive"),
                                            (0.1, "negative"),
                                            (1.0, "positive")])
def test_factored_threshold_given_the_references_scores(rate, selection):
    rng = np.random.default_rng(1)
    _, scores = ref_ch.factored_scores(
        jax.tree_util.tree_map(jnp.asarray, _grad_tree(rng)))
    want = ref_ch.factored_threshold(scores, rate, selection)
    got = port_ch.factored_threshold(
        [None if s is None else torch.from_numpy(np.array(s))
         for s in scores], rate, selection)
    assert np.float32(got.item()) == np.float32(want)


def _tie_grads(rng, k_clients):
    """K clients' gradients where 21 columns have the squared norm 4
    exactly (columns of ±1 and 0 entries) and every other score is far
    above it, so the 0.1-quantile (position 14) is a tied score."""
    trees = []
    for _ in range(k_clients):
        t = _grad_tree(rng)
        t["stack"]["l0"]["attn"]["q"]["b"] *= 10
        t["stack"]["l0"]["norm1"]["scale"] *= 10
        for path in (("embed", "w"), ("unembed", "w")):
            leaf = t[path[0]][path[1]]
            for j in range(0, leaf.shape[-1], 3):
                col = np.zeros(leaf.shape[:-1], np.float32)
                col.reshape(-1)[:4] = np.array([1, -1, 1, -1], np.float32)
                leaf[..., j] = col
        trees.append(t)
    return trees


@pytest.mark.parametrize("rate", [0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masks_bitwise_given_the_references_scores_and_threshold(rate,
                                                                 dtype):
    """Three clients' trees masked in one slot-stacked pass
    (``factored_mask_slots``) with each client's reference scores and
    threshold: the masked leaves and the uploaded fraction are the
    reference's ``apply_factored_mask`` bitwise — channels whose score
    equals the threshold kept, every channel at rate 1 (threshold -inf)."""
    rng = np.random.default_rng(2)
    trees = _tie_grads(rng, 3)
    jd = jnp.dtype(dtype)
    refs = [jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), t)
            for t in trees]
    want, scores, thrs, ties = [], [], [], 0
    for rt in refs:
        _, s = ref_ch.factored_scores(rt)
        thr = ref_ch.factored_threshold(s, rate)
        ties += sum(int(np.sum(np.asarray(x) == np.asarray(thr)))
                    for x in s if x is not None)
        want.append(ref_ch.apply_factored_mask(rt, rate))
        scores.append(s)
        thrs.append(float(thr))
    if rate < 1.0:                              # the case under test
        assert ties >= (3 * 21 if rate == 0.9 else 3)
    leaves = [torch.stack(ls) for ls in zip(*(
        tree_leaves(from_numpy_tree(_np(rt), "cpu")) for rt in refs))]
    port_scores = [None if s0 is None else torch.from_numpy(np.stack(
        [np.asarray(s[i]) for s in scores]))
        for i, s0 in enumerate(scores[0])]
    masked, frac = port_ch.factored_mask_slots(
        leaves, port_scores, torch.tensor(thrs, dtype=torch.float32))
    for k, (wm, wf) in enumerate(want):
        assert np.float32(frac[k].item()) == np.float32(wf)
        for a, b in zip(jax.tree_util.tree_leaves(wm), masked):
            got = b[k].to(torch.float32).numpy()
            assert np.array_equal(got, np.asarray(a, np.float32))
            assert np.array_equal(np.signbit(got),
                                  np.signbit(np.asarray(a, np.float32)))


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_apply_factored_mask_end_to_end(rate):
    """Scores, threshold and mask all from the port: the reference's masks
    and fraction exactly where no score but the one the threshold lands on
    lies within rtol 1e-5 of it (asserted), so the two packages' last-bit
    score differences cannot reorder the channels around it."""
    rng = np.random.default_rng(3)
    tree = _grad_tree(rng)
    want, wf = ref_ch.apply_factored_mask(
        jax.tree_util.tree_map(jnp.asarray, tree), rate)
    _, scores = ref_ch.factored_scores(
        jax.tree_util.tree_map(jnp.asarray, tree))
    thr = float(ref_ch.factored_threshold(scores, rate))
    near = sum(int(np.sum(np.isclose(np.asarray(s), thr, rtol=1e-5,
                                     atol=0)))
               for s in scores if s is not None)
    assert near <= 1
    got, gf = port_ch.apply_factored_mask(from_numpy_tree(tree, "cpu"),
                                          rate)
    assert np.float32(gf.item()) == np.float32(wf)
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert np.array_equal(b.numpy(), np.asarray(a))


def test_only_vector_leaves_upload_everything():
    """No >= 2-D leaf: nothing to rank, a -inf threshold, fraction 1 (the
    reference's empty-pool rule)."""
    tree = {"scale": torch.ones(5), "bias": torch.zeros(3)}
    _, scores = port_ch.factored_scores(tree)
    assert float(port_ch.factored_threshold(scores, 0.25)) == -np.inf
    masked, frac = port_ch.apply_factored_mask(tree, 0.25)
    assert float(frac) == 1.0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree),
                                                 tree_leaves(masked)))


@pytest.mark.parametrize("leaves,slots,tables", [
    (14, 5, [(0, 14)]),                     # qwen2-0.5b: one table a step
    (40, 1, [(0, 16), (16, 32), (32, 40)]),
    (40, 300, [(0, 13), (13, 26), (26, 39), (39, 40)]),   # MAX_SLOTS
    (0, 5, []),
])
def test_leaf_tables(leaves, slots, tables):
    assert port_ch.leaf_tables(leaves, slots) == tables
    for a, b in tables:
        assert b - a <= min(cn.MAX_LEAVES, sm.MAX_LEAVES)
        assert (b - a) * slots <= sm.MAX_SLOTS
    with pytest.raises(ValueError, match="MAX_SLOTS"):
        port_ch.leaf_tables(1, sm.MAX_SLOTS + 1)


def test_a_tree_past_max_leaves_is_masked_in_groups(monkeypatch):
    """40 matrices of 2 clients: 3 tables, so 3 calls of each wrapper of
    at most MAX_LEAVES leaves, and each client's masks and fraction those
    of the reference on it."""
    rng = np.random.default_rng(4)
    trees = [{f"w{i:02d}": rng.normal(size=(6, 5 + i % 4)).astype(np.float32)
              for i in range(40)} for _ in range(2)]
    calls = {"norms": [], "masks": []}
    norms, masks = port_ch.channel_norms_leaves, port_ch.select_mask_leaves

    def count_norms(gs):
        calls["norms"].append(len(gs))
        return norms(gs)

    def count_masks(ls, **kw):
        calls["masks"].append(len(ls))
        return masks(ls, **kw)

    monkeypatch.setattr(port_ch, "channel_norms_leaves", count_norms)
    monkeypatch.setattr(port_ch, "select_mask_leaves", count_masks)
    stacked = {k: torch.from_numpy(np.stack([t[k] for t in trees]))
               for k in trees[0]}
    got, frac = port_ch.apply_factored_mask_slots(stacked, 0.2)
    assert calls == {"norms": [16, 16, 8], "masks": [16, 16, 8]}
    for k, t in enumerate(trees):
        want, wf = ref_ch.apply_factored_mask(
            jax.tree_util.tree_map(jnp.asarray, t), 0.2)
        assert np.float32(frac[k].item()) == np.float32(wf)
        for name in t:
            assert np.array_equal(got[name][k].numpy(),
                                  np.asarray(want[name]))


def _lm_pair(dtype, arch="qwen2-0.5b"):
    ref_cfg = dataclasses.replace(
        ref_configs.smoke_variant(ref_configs.get(arch)), dtype=dtype)
    port_cfg = dataclasses.replace(
        port_configs.smoke_variant(port_configs.get(arch)), dtype=dtype)
    rb = ref_zoo.build(ref_cfg)
    pb = port_zoo.build(port_cfg, device="cpu")
    rp, _ = rb.init(jax.random.PRNGKey(0))
    return rb, pb, rp, from_numpy_tree(_np(rp), "cpu")


def _updated_columns(delta):
    """Which output channels (last axis) an update touched."""
    return np.any(delta.reshape(-1, delta.shape[-1]) != 0, axis=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_federated_lm_step_two_steps(dtype):
    """Two federated steps of the smoke qwen2-0.5b, K = 2 clients of 2
    sequences of 16 tokens, rate 0.10, lr 0.05, through both packages'
    ``make_federated_train_step``.  The params agree (fp32: within 1e-5;
    bf16: two bf16 ulps of 1.0), and so does what the steps changed, leaf
    by leaf: the update (new -
    initial) within a tolerance relative to the reference's update (fp32
    5e-5, bf16 0.25: a bf16 param rounds each step to its own ulp, so the
    port's and the reference's updates differ by up to an ulp an entry),
    a leaf the reference left unchanged unchanged, and the output channels
    each ≥2-D leaf's update touched — the mask — equal (fp32), or equal
    but for 1% of a leaf's channels (bf16, whose scores tie more)."""
    _two_federated_steps("qwen2-0.5b", dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_federated_moe_step_two_steps(dtype):
    """The same two steps on the smoke deepseek-v2 (MLA, a dense prefix
    layer and an MoE layer of top-2 of 4 routed experts plus a shared
    one): 22 scored leaves, in bf16 the router fp32 among bf16 leaves, so
    a step's K1 and K2 run over leaf tables of each dtype.  The same
    tolerances as qwen2-0.5b's but for the bf16 mask, which may differ in
    1% of all the tree's scored channels rather than of each leaf's: its
    first layers' leaves (192 to 512 channels) each flip up to 5 channels
    whose bf16 scores lie at the threshold."""
    _two_federated_steps("deepseek-v2-236b", dtype, flips_per_leaf=False)


@pytest.mark.parametrize("arch,dtype", [("mamba2-2.7b", "float32"),
                                        ("mamba2-2.7b", "bfloat16"),
                                        ("jamba-1.5-large-398b", "float32")])
def test_federated_ssm_step_two_steps(arch, dtype):
    """The same two steps on the smoke mamba2 (2 Mamba layers, 13 scored
    leaves, in bf16 ``A_log`` and ``D_res`` fp32 among bf16 leaves: a
    step's K1 and K2 run over a bf16 and an fp32 leaf table) and jamba
    ([mamba + MLP, attention + MoE]), with deepseek-v2's tolerances.
    jamba is held in fp32 only: in bf16 its MLP's channels tie at the
    threshold often enough (3,485 against 3,499 kept entries of ``wg``)
    that a leaf's update moves past the 0.25 relative bound."""
    _two_federated_steps(arch, dtype, flips_per_leaf=False)


@pytest.mark.parametrize("arch,dtype", [("whisper-medium", "float32"),
                                        ("whisper-medium", "bfloat16"),
                                        ("llama-3.2-vision-11b", "float32")])
def test_federated_encdec_step_two_steps(monkeypatch, arch, dtype):
    """The same two steps on the smoke whisper (2 encoder and 2 decoder
    layers, 32 scored leaves: the encoder's beside the decoder's and the
    cross sublayer's) and llama-3.2-vision ([self, self + cross], 8 patch
    tokens), each client with its own context embeddings (K, B, T, D),
    with deepseek-v2's tolerances.  In fp32 each client's kept entries
    are the reference's exactly: the fraction (bitwise) and the nonzero
    count of every masked leaf, the reference's from ``jax.vmap`` of its
    gradient and ``apply_factored_mask`` a client.  llama-3.2-vision is
    held in fp32 only, as jamba: in bf16 a leaf's update is a few bf16
    ulps (``final_norm``'s one changed entry, the second layer's ``o`` and
    ``wg``), and one ulp the other way moves it past the 0.25 relative
    bound."""
    _two_federated_steps(arch, dtype, flips_per_leaf=False,
                         kept=monkeypatch if dtype == "float32" else None)


def _client_embeds(cfg, k_clients, batch, step):
    """Each client's own context embeddings (K, B, T, D) in the model
    dtype's numpy type (normal, scale 1/sqrt(d_model)), or {}."""
    context = port_zoo.context_input(cfg)
    if context is None:
        return {}
    rng = np.random.default_rng(100 + step)
    x = rng.normal(size=(k_clients, batch, context[1], cfg.d_model)) \
        / np.sqrt(cfg.d_model)
    return {context[0]: x.astype(np.float32)}


def _reference_kept(rb, rp, batch):
    """Each client's (fraction, nonzero count of every masked leaf) of the
    reference's step on ``batch``: its gradients by ``jax.vmap``, masked a
    client by ``apply_factored_mask``."""
    _, grads = jax.vmap(jax.value_and_grad(rb.loss_fn), in_axes=(None, 0))(
        rp, batch)
    out = []
    for k in range(next(iter(batch.values())).shape[0]):
        masked, frac = ref_ch.apply_factored_mask(
            jax.tree_util.tree_map(lambda g, k=k: g[k], grads), 0.10)
        out.append((np.float32(frac), [int(np.count_nonzero(np.asarray(g)))
                                       for g in
                                       jax.tree_util.tree_leaves(masked)]))
    return out


def _port_kept(monkeypatch):
    """Record each step's (fraction, nonzero count of every masked leaf)
    a client, as ``core.channels`` masks the clients' gradients."""
    seen = []
    real = port_ch.apply_factored_mask_slots

    def tap(grads_k, rate, selection="positive", in_place=False):
        masked, frac = real(grads_k, rate, selection, in_place=in_place)
        leaves = tree_leaves(masked)
        seen.append([(np.float32(frac[k].item()),
                      [int(torch.count_nonzero(t[k])) for t in leaves])
                     for k in range(frac.shape[0])])
        return masked, frac

    monkeypatch.setattr(port_ch, "apply_factored_mask_slots", tap)
    return seen


def _two_federated_steps(arch, dtype, flips_per_leaf=True, kept=None):
    rb, pb, rp, pp = _lm_pair(dtype, arch)
    init = [np.asarray(a, np.float32).astype(np.float64)
            for a in jax.tree_util.tree_leaves(rp)]
    K, B, S = 2, 2, 16
    ref_step = jax.jit(ref_dist.make_federated_train_step(
        lambda p, b: rb.loss_fn(p, b), RefScbf(upload_rate=0.10), lr=0.05))
    port_step = port_dist.make_federated_train_step(
        pb.loss_fn, ScbfConfig(upload_rate=0.10), lr=0.05)
    stream = ref_tokens.SyntheticTokenStream(K * B, S, pb.cfg.vocab_size)
    port_kept = None if kept is None else _port_kept(kept)
    for i, nb in zip(range(2), stream):
        nb = {k: v.reshape(K, B, S) for k, v in nb.items()}
        nb.update(_client_embeds(pb.cfg, K, B, i))
        rbatch = {k: jnp.asarray(v).astype(rb.ctx.dtype) if v.ndim == 4
                  else jnp.asarray(v) for k, v in nb.items()}
        if kept is not None:
            want_kept = _reference_kept(rb, rp, rbatch)
        wl, rp = ref_step(rp, rbatch)
        gl, pp = port_step(pp, {k: torch.from_numpy(v).to(pb.ctx.dtype)
                                if v.ndim == 4 else torch.from_numpy(v)
                                for k, v in nb.items()})
        if kept is not None:
            assert port_kept[-1] == want_kept
        if dtype == "float32":
            assert float(gl) == pytest.approx(float(wl), rel=1e-5)
        else:
            assert float(gl) == pytest.approx(float(wl), rel=2e-2)
    rel = 5e-5 if dtype == "float32" else 0.25
    partial = flips = channels = 0
    for a, b, p0 in zip(jax.tree_util.tree_leaves(rp),
                        tree_leaves(to_numpy_tree(pp)), init):
        assert b.dtype == np.float32
        tol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7
        np.testing.assert_allclose(b, np.asarray(a, np.float32), rtol=tol,
                                   atol=tol)
        want = np.asarray(a, np.float32).astype(np.float64) - p0
        got = b.astype(np.float64) - p0
        norm = np.linalg.norm(want)
        if norm == 0.0:
            assert not np.any(got)
            continue
        assert np.linalg.norm(got - want) <= rel * norm
        if want.ndim >= 2:
            cols, got_cols = _updated_columns(want), _updated_columns(got)
            leaf_flips = int(np.count_nonzero(cols != got_cols))
            if flips_per_leaf or dtype == "float32":
                assert leaf_flips <= (0 if dtype == "float32"
                                      else cols.size // 100)
            flips += leaf_flips
            channels += cols.size
            partial += int(0 < np.count_nonzero(cols) < cols.size)
    assert flips <= channels // 100
    # the mask left channels out, so the column check checked a mask; and
    # the update stands well above the fp32 params' absolute tolerance
    assert partial >= 5
    assert max(np.abs(np.asarray(a, np.float32) - p0).max() for a, p0 in
               zip(jax.tree_util.tree_leaves(rp), init)) > 1e3 * 1e-5
    assert [t.dtype for t in tree_leaves(pp)] == [
        torch.float32 if a.dtype == np.float32 else torch.bfloat16
        for a in jax.tree_util.tree_leaves(rp)]


def _quad_loss_ref(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _quad_loss_port(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _quad(k=3, n=32, d=16, out=32, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"x": rng.normal(size=(k, n, d)).astype(np.float32),
             "y": rng.normal(size=(k, n, out)).astype(np.float32)}
    params = {"w": rng.normal(size=(d, out)).astype(np.float32),
              "b": np.zeros((out,), np.float32)}
    return params, batch


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("rate", [0.25, 1.0])
def test_federated_step_on_a_quadratic(compressed, rate):
    """The reference's quadratic-loss step, 3 clients, random data without
    score ties: dense masks and the compressed exchange (top-k, then
    ``index_add_``), params within 1e-5."""
    params, batch = _quad()
    want_l, want = ref_dist.make_federated_train_step(
        _quad_loss_ref, RefScbf(upload_rate=rate,
                                compressed_exchange=compressed), lr=0.1)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, batch))
    got_l, got = port_dist.make_federated_train_step(
        _quad_loss_port, ScbfConfig(upload_rate=rate,
                                    compressed_exchange=compressed), lr=0.1)(
        from_numpy_tree(params, "cpu"), from_numpy_tree(batch, "cpu"))
    assert float(got_l) == pytest.approx(float(want_l), rel=1e-6)
    for name in params:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5)
    if rate < 1.0:                  # most output channels untouched
        delta = got["w"].numpy() - params["w"]
        assert np.mean(np.all(delta == 0, axis=0)) > 0.4


def test_compressed_sum_and_masked_on_random_data():
    """``_compressed_sum`` of slot-stacked leaves and ``_compressed_masked``
    of one tree against the reference's, random data (no ties)."""
    rng = np.random.default_rng(5)
    grads_k = {"w": rng.normal(size=(3, 8, 5, 20)).astype(np.float32),
               "b": rng.normal(size=(3, 20)).astype(np.float32)}
    want = ref_dist._compressed_sum(
        jax.tree_util.tree_map(jnp.asarray, grads_k), 0.25)
    got = port_dist._compressed_sum(from_numpy_tree(grads_k, "cpu"), 0.25)
    for name in grads_k:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-6)
    one = {"w": rng.normal(size=(16, 32)).astype(np.float32),
           "s": rng.normal(size=(32,)).astype(np.float32)}
    want = ref_dist._compressed_masked(
        jax.tree_util.tree_map(jnp.asarray, one), 0.25)
    got = port_dist._compressed_masked(from_numpy_tree(one, "cpu"), 0.25)
    for name in one:
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))


def test_federated_step_learns():
    """The reference's learning check on the port: 60 steps at rate 0.5
    bring the loss below 0.3 of its start."""
    rng = np.random.default_rng(5)
    w_true = rng.normal(size=(8, 4)).astype(np.float32)
    x = rng.normal(size=(2, 64, 8)).astype(np.float32)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(x @ w_true)}
    params = {"w": torch.from_numpy(
        np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32)),
        "b": torch.zeros(4)}
    step = port_dist.make_federated_train_step(
        _quad_loss_port, ScbfConfig(upload_rate=0.5), lr=0.05)
    losses = []
    for _ in range(60):
        loss, params = step(params, batch)
        losses.append(float(loss))
    assert losses[-1] < 0.3 * losses[0]


def test_client_gradients_fill_one_buffer_a_leaf():
    params, batch = _quad(k=2)
    tp, tb = from_numpy_tree(params, "cpu"), from_numpy_tree(batch, "cpu")
    losses, grads = port_dist.client_gradients(_quad_loss_port, tp, tb)
    assert losses.shape == (2,)
    for k in range(2):
        want = jax.grad(_quad_loss_ref)(
            jax.tree_util.tree_map(jnp.asarray, params),
            {n: jnp.asarray(v[k]) for n, v in batch.items()})
        for name in params:
            assert grads[name].shape == (2,) + params[name].shape
            np.testing.assert_allclose(grads[name][k].numpy(),
                                       np.asarray(want[name]), rtol=1e-5,
                                       atol=1e-6)
    assert not any(t.requires_grad for t in tree_leaves(tp))


@pytest.mark.parametrize("batch,seq,vocab,seed", [(4, 16, 512, 0),
                                                  (3, 7, 151936, 9)])
def test_synthetic_lm_batch_is_the_references(batch, seq, vocab, seed):
    want = ref_tokens.synthetic_lm_batch(batch, seq, vocab, seed)
    got = port_tokens.synthetic_lm_batch(batch, seq, vocab, seed)
    for k in ("tokens", "targets"):
        assert got[k].dtype == np.int32
        assert np.array_equal(got[k], want[k])
    ws = ref_tokens.SyntheticTokenStream(batch, seq, vocab, seed)
    gs = port_tokens.SyntheticTokenStream(batch, seq, vocab, seed)
    for (_, a), (_, b) in zip(zip(range(3), ws), zip(range(3), gs)):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_client_batch_shape():
    assert port_dist.client_batch_shape(20, 5, 64) == \
        ref_dist.client_batch_shape(20, 5, 64) == (5, 4, 64)
    with pytest.raises(ValueError):
        port_dist.client_batch_shape(21, 5, 64)


def test_tree_unflatten_round_trip():
    tree = {"b": {"z": torch.ones(2), "a": [torch.zeros(1), torch.ones(3)]},
            "a": torch.arange(4)}
    leaves = tree_leaves(tree)
    assert [t.numel() for t in leaves] == [4, 1, 3, 2]   # sorted keys
    back = tree_unflatten(tree, leaves)
    assert list(back) == ["b", "a"] and list(back["b"]) == ["z", "a"]
    with pytest.raises(ValueError):
        tree_unflatten(tree, leaves + [torch.ones(1)])


def test_tree_map_walks_in_flatten_order():
    """``params.tree_map`` — the port's one walker — visits the leaves in
    ``tree_leaves``'s order (a dict's keys sorted), keeps each dict's key
    order and passes ``None`` through as an empty subtree, as
    ``tree_leaves`` and ``tree_unflatten`` do; the optimizers and server
    rules walk with it."""
    from repro_torch.optim.sgd import apply_updates
    from repro_torch.params import tree_map

    tree = {"b": {"z": torch.ones(2), "n": None,
                  "a": [torch.zeros(1), torch.ones(3)]},
            "a": torch.arange(4.0)}
    seen = []
    out = tree_map(lambda t: seen.append(t.numel()) or t * 2, tree)
    assert seen == [t.numel() for t in tree_leaves(tree)] == [4, 1, 3, 2]
    assert list(out) == ["b", "a"] and list(out["b"]) == ["z", "n", "a"]
    assert out["b"]["n"] is None
    back = tree_unflatten(tree, tree_leaves(out))
    assert back["b"]["n"] is None and torch.equal(back["a"], out["a"])
    upd = tree_map(lambda t: None if t.numel() == 1 else torch.ones_like(t),
                   tree)
    new = apply_updates(tree, upd)
    assert torch.equal(new["b"]["a"][0], tree["b"]["a"][0])
    assert torch.equal(new["a"], tree["a"] + 1)


def _tree_grads(arch, dtype, k_clients=2):
    """The smoke model's params and a (K, ...) gradient tree of K clients
    (random batches), through ``client_gradients``."""
    _, pb, _, pp = _lm_pair(dtype, arch)
    nb = port_tokens.synthetic_lm_batch(k_clients * 2, 16, pb.cfg.vocab_size,
                                        0)
    batch = {k: torch.from_numpy(v).reshape(k_clients, 2, 16)
             for k, v in nb.items()}
    return pb, pp, batch, port_dist.client_gradients(pb.loss_fn, pp,
                                                     batch)[1]


def _count_tables(monkeypatch):
    """Record each K1 and K2 call's leaf dtypes (the wrappers as
    ``core.channels`` calls them)."""
    calls = {"norms": [], "masks": []}
    norms, masks = port_ch.channel_norms_leaves, port_ch.select_mask_leaves

    def count_norms(gs):
        calls["norms"].append([g.dtype for g in gs])
        return norms(gs)

    def count_masks(ls, **kw):
        calls["masks"].append([leaf[0].dtype for leaf in ls])
        return masks(ls, **kw)

    monkeypatch.setattr(port_ch, "channel_norms_leaves", count_norms)
    monkeypatch.setattr(port_ch, "select_mask_leaves", count_masks)
    return calls


def test_leaf_tables_hold_one_dtype(monkeypatch):
    """A tree of mixed dtypes: the smoke deepseek-v2 in bf16 has 21 bf16
    scored leaves and the fp32 router (K1 and K2 take one dtype a launch
    on the card); every table handed to K1 and K2 holds one dtype —
    the bf16 leaves in tree order as 16 + 5, then the router — and each
    client's masks and fraction are those of the reference's
    ``apply_factored_mask`` given the port's scores' threshold, leaf for
    leaf as the port's own one-client masking gives them."""
    _, _, _, grads_k = _tree_grads("deepseek-v2-236b", "bfloat16")
    leaves = tree_leaves(grads_k)
    assert sum(t.ndim >= 3 for t in leaves) == 22
    assert [t.dtype for t in leaves if t.ndim >= 3].count(torch.float32) == 1
    calls = _count_tables(monkeypatch)
    masked, frac = port_ch.apply_factored_mask_slots(grads_k, 0.1)
    bf, f32 = torch.bfloat16, torch.float32
    assert calls == {"norms": [[bf] * 16, [bf] * 5, [f32]],
                     "masks": [[bf] * 16, [bf] * 5, [f32]]}
    # the same masks, client by client, as a one-client tree
    for k in range(2):
        one, f1 = port_ch.apply_factored_mask(
            tree_unflatten(grads_k, [t[k] for t in leaves]), 0.1)
        assert torch.equal(f1, frac[k])
        assert all(torch.equal(a, b[k]) for a, b in
                   zip(tree_leaves(one), tree_leaves(masked)))


@pytest.mark.parametrize("arch,bf16,fp32", [
    ("mamba2-2.7b", 11, ["A_log", "D_res"]),
    ("jamba-1.5-large-398b", 16, ["A_log", "D_res", "w"]),
])
def test_ssm_step_tables_hold_one_dtype(monkeypatch, arch, bf16, fp32):
    """The smoke mamba2 and jamba in bf16: K1 and K2 each take the bf16
    scored leaves in tree order, then one fp32 table holding exactly the
    Mamba layers' ``A_log`` and ``D_res`` (and jamba's router); the masks
    and fractions are the one-client pass's."""
    _, _, _, grads_k = _tree_grads(arch, "bfloat16")
    paths = [p for p, t in tree_paths(grads_k) if t.ndim >= 3
             and t.dtype == torch.float32]
    assert [p[-1] for p in paths] == fp32
    calls = _count_tables(monkeypatch)
    masked, frac = port_ch.apply_factored_mask_slots(grads_k, 0.1)
    bf, f32 = torch.bfloat16, torch.float32
    scored = sum(t.ndim >= 3 for t in tree_leaves(grads_k))
    want = [[bf] * bf16] + ([[bf] * (scored - len(fp32) - bf16)]
                            if scored - len(fp32) > bf16 else []) \
        + [[f32] * len(fp32)]
    assert calls == {"norms": want, "masks": want}
    leaves = tree_leaves(grads_k)
    for k in range(2):
        one, f1 = port_ch.apply_factored_mask(
            tree_unflatten(grads_k, [t[k] for t in leaves]), 0.1)
        assert torch.equal(f1, frac[k])
        assert all(torch.equal(a, b[k]) for a, b in
                   zip(tree_leaves(one), tree_leaves(masked)))


def test_single_dtype_trees_keep_their_tables(monkeypatch):
    """Grouping by dtype leaves a one-dtype tree's tables as
    ``leaf_tables`` cuts them: qwen2-0.5b's 14 leaves in one table, the
    fp32 deepseek-v2's 22 as 16 + 6."""
    for arch, dtype, sizes in (("qwen2-0.5b", "bfloat16", [14]),
                               ("deepseek-v2-236b", "float32", [16, 6])):
        _, _, _, grads_k = _tree_grads(arch, dtype)
        calls = _count_tables(monkeypatch)
        port_ch.apply_factored_mask_slots(grads_k, 0.1)
        assert [len(c) for c in calls["norms"]] == sizes
        assert [len(c) for c in calls["masks"]] == sizes


@pytest.mark.parametrize("arch,dtype", [("qwen2-0.5b", "bfloat16"),
                                        ("qwen2-0.5b", "float32"),
                                        ("deepseek-v2-236b", "bfloat16")])
def test_step_is_bitwise_the_unfused_sum_and_update(arch, dtype):
    """The step changes only where it keeps its buffers: K2 masks the
    gradients in place and the sum and SGD update run leaf by leaf.  The
    new params are bitwise those of the out-of-place composition — masks
    into new tensors, every leaf summed, then ``sgd_update`` — from the
    same gradients."""
    pb, pp, batch, grads_k = _tree_grads(arch, dtype)
    masked, _ = port_ch.apply_factored_mask_slots(
        tree_unflatten(grads_k, [t.clone() for t in tree_leaves(grads_k)]),
        0.1)
    summed = tree_unflatten(masked, [torch.sum(t, axis=0)
                                     for t in tree_leaves(masked)])
    want = port_zoo.sgd_update(pp, summed, 0.05)
    loss, got = port_dist.make_federated_train_step(
        pb.loss_fn, ScbfConfig(upload_rate=0.1), lr=0.05)(pp, batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(want),
                                                 tree_leaves(got)))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(pp),
                                                     tree_leaves(got)))


def test_in_place_masking_is_the_out_of_place_one():
    """``in_place`` writes each scored leaf's masked values over the leaf:
    the same values and fraction as the out-of-place pass, in the leaves
    handed in; the unscored leaves are passed through."""
    _, _, _, grads_k = _tree_grads("deepseek-v2-236b", "bfloat16")
    leaves = tree_leaves(grads_k)
    copy = tree_unflatten(grads_k, [t.clone() for t in leaves])
    want, wf = port_ch.apply_factored_mask_slots(copy, 0.1)
    got, gf = port_ch.apply_factored_mask_slots(grads_k, 0.1, in_place=True)
    assert torch.equal(wf, gf)
    for a, b, leaf in zip(tree_leaves(want), tree_leaves(got), leaves):
        assert torch.equal(a, b) and b.data_ptr() == leaf.data_ptr()
