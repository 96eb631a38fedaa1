"""The zoo on a ``(data, model)`` mesh of gloo CPU ranks (ROADMAP A15b):
params as DTensors placed by ``sharding.rules`` (FSDP over ``data``,
tensor and expert parallel over ``model``), the shard points, serving
and SCBF's federated step with K1 and K2 on each rank's local shards.

The reference's own sharded path fails under jax 0.9 (ROADMAP C's
caveat), so its *unsharded* functions are the oracle: a shard point
places data and changes no math.  At the smoke widths in fp32:

* serving (prefill of 8 tokens, 4 decode steps past a ring of 10 slots)
  on (2, 2), (2, 1) and (1, 2): logits within rtol 1e-5 / atol 1e-5 of
  the unsharded port, and the unsharded port within 2e-4 of the
  reference's (``tests/test_torch_models.py``'s gate), greedy tokens
  equal; attention head parallel where the KV heads divide ``model``,
  and sequence parallel where they do not (qwen2 with one KV head,
  ``MQA``, on (1, 2)); deepseek-v2 also on (2, 2), its decode steps
  through the sequence-parallel MLA wherever ``model`` splits the
  latent cache, its prefill never; one decode step's collectives on
  (1, 2) a hand count, none of them a block of the cache;
* the federated step (4 clients, dense exchange) on (2, 2), and on
  (2, 1, 2) and (2, 2, 1) with pods: the loss within 1e-6 relative,
  params within atol 1e-6, and K1 and K2 called once a leaf table a
  rank, on plain local shards; and the selection of one device's
  gradients of a pod's clients, whole and placed as the params: every
  client's channel scores and threshold within rtol 1e-6, the kept
  columns' values equal and the dropped ones 0 but at scores within
  1e-6 relative of the threshold (counted: 0 with these inputs), the
  fraction within rtol 1e-6; and the same for the sequence-parallel
  attention (``MQA`` on (1, 2)), ``MQA`` on (2, 1) and mamba2 on (1, 2)
  (the SSD head parallel, the projections tensor parallel);
* the compressed exchange on the same five meshes, against the
  one-device compressed step: the loss within 1e-6 relative, params
  within atol 1e-6, no K1 or K2 call, no channel score within 1e-6 of
  a client's k-th; ``_compressed_sum`` of one device's gradients placed
  as the params bitwise the one-device sum (a vector leaf across pods
  within 1e-6 relative: each pod's fp32 partial sum is all-reduced, so
  its clients add in another order); the bytes a rank sends across
  pods equal to a hand count of its in-range entries, padded to the
  pod group's largest count, and below the dense exchange's;
* expert parallelism for the MoE smoke config on (1, 2): routing tables
  equal, outputs allclose, with and without ``moe_dshard``;
* a DTensor handed to a kernel wrapper raises.
"""
import concurrent.futures
import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as ref_configs
from repro.models import model_zoo as ref_zoo
from repro_torch.launch import mesh as pod
from repro_torch.sharding import mesh as meshes
from repro_torch.sharding import rules

import _torch_pod_ranks as ranks

GROUP_TIMEOUT_S = 120.0
JOIN_TIMEOUT_S = 480.0
NO_DROPS = {"moe_capacity_factor": 8.0}
MQA = {"num_kv_heads": 1}        # a KV head that 2 ranks cannot split
SERVE = [("qwen2-0.5b", {}, {}), ("deepseek-v2-236b", NO_DROPS, {}),
         ("mamba2-2.7b", {}, {}), ("qwen2-0.5b", MQA, {})]


def _spawn(fn, world, *args):
    return pod.spawn_ranks(fn, world, args, device="cpu",
                           timeout_s=GROUP_TIMEOUT_S,
                           join_timeout_s=JOIN_TIMEOUT_S)


def _ref_cfg(arch, cfg_kw):
    return dataclasses.replace(
        ref_configs.smoke_variant(ref_configs.get(arch)), dtype="float32",
        **cfg_kw)


def _ref_params(arch, cfg_kw, **build_kw):
    rb = ref_zoo.build(_ref_cfg(arch, cfg_kw), remat=False, **build_kw)
    rp, _ = rb.init(jax.random.PRNGKey(0))
    return rb, rp, jax.tree_util.tree_map(np.asarray, rp)


def _tokens(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(ranks.MESH_B, ranks.MESH_P
                                        + ranks.MESH_T)).astype(np.int32)


def _ref_serve(rb, rp, toks):
    """The reference's logits of ``ranks._serve``'s steps."""
    logits, caches = rb.prefill_step(rp, {
        "tokens": jnp.asarray(toks[:, :ranks.MESH_P]),
        "caches": rb.make_cache(ranks.MESH_B, ranks.MESH_CACHE)})
    out = [np.asarray(logits)]
    for s in range(ranks.MESH_P, ranks.MESH_P + ranks.MESH_T):
        logits, caches = rb.decode_step(rp, {
            "token": jnp.asarray(toks[:, s:s + 1]),
            "pos": jnp.full((ranks.MESH_B, 1), s, jnp.int32),
            "caches": caches})
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def groups():
    """Every rank body in two groups, one of 2 ranks ((2, 1) and (1, 2)
    meshes) and one of 4 ((2, 2) and (2, 1, 2)); the reference's serving
    logits of each config."""
    refs, two, four = {}, [], []
    for arch, cfg_kw, build_kw in SERVE:
        rb, rp, np_params = _ref_params(arch, cfg_kw)
        toks = _tokens(rb.cfg.vocab_size)
        refs[_label(arch, cfg_kw)] = _ref_serve(rb, rp, toks)
        for shape in ((2, 1), (1, 2)):
            two.append((arch, cfg_kw, shape, np_params, toks, build_kw))
        if cfg_kw == MQA:
            mqa_params = np_params
        elif arch == "qwen2-0.5b":
            four.append((arch, cfg_kw, (2, 2), np_params, toks, build_kw))
            fed_params = np_params
        elif arch == "deepseek-v2-236b":
            four.append((arch, cfg_kw, (2, 2), np_params, toks, build_kw))
            mla = (np_params, toks, cfg_kw)
        elif arch == "mamba2-2.7b":
            ssm = ([(1, 2)], arch, np_params,
                   ranks.lm_batch(rb.cfg.vocab_size))
    cfg = _ref_cfg("deepseek-v2-236b", NO_DROPS)
    from repro.models import moe as ref_moe
    layer, _ = ref_moe.moe_init(jax.random.PRNGKey(1), cfg, jnp.float32)
    x = np.random.default_rng(2).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)
    batch = ranks.lm_batch(ranks._mesh_cfg("qwen2-0.5b", {}).vocab_size)
    # the two groups run at once, on 6 of the host's cores
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two_ranks = pool.submit(_spawn, ranks.mesh_jobs, 2, [
            ("mesh_serving", (two,)),
            ("mesh_experts", (jax.tree_util.tree_map(np.asarray, layer), x,
                              NO_DROPS)),
            ("mesh_federated", ([(1, 2), (2, 1)], "qwen2-0.5b", mqa_params,
                                batch, MQA)),
            ("mesh_mla_decode", mla),
            ("mesh_federated", ssm)])
        four_ranks = pool.submit(_spawn, ranks.mesh_jobs, 4, [
            ("mesh_serving", (four,)),
            ("mesh_federated", ([(2, 2), (2, 1, 2), (2, 2, 1)],
                                "qwen2-0.5b", fed_params, batch)),
            ("mesh_placements", (["qwen2-0.5b", "deepseek-v2-236b",
                                  "mamba2-2.7b"],))])
        got2, got4 = two_ranks.result(), four_ranks.result()
    return {"refs": refs, "serving2": [r[0] for r in got2],
            "experts": [r[1] for r in got2],
            "federated_mqa": [r[2] for r in got2],
            "mla_decode": [r[3] for r in got2],
            "federated_ssm": [r[4] for r in got2],
            "serving4": [r[0] for r in got4],
            "federated": [r[1] for r in got4], "placements": got4[0][2]}


@pytest.fixture(scope="module")
def serving(groups):
    return groups["refs"], groups["serving2"], groups["serving4"]


def _label(arch, cfg_kw):
    return arch + ("-mqa" if cfg_kw == MQA else "")


CASES = [(_label(a, kw), s) for a, kw, _ in SERVE
         for s in ((2, 1), (1, 2))] + [("qwen2-0.5b", (2, 2)),
                                       ("deepseek-v2-236b", (2, 2))]


@pytest.mark.parametrize("label,shape", CASES)
def test_sharded_serving_matches_one_device_and_the_reference(serving,
                                                              label, shape):
    refs, got, got4 = serving
    groups = got4 if shape == (2, 2) else got
    for res in groups:                 # every rank
        case = next(c for c in res if _label(c["arch"], c["cfg_kw"])
                    == label and tuple(c["shape"]) == shape)
        assert case["cache_types"] == ["DTensor"]
        # sequence parallel where the KV heads do not divide ``model``
        assert (case["seq_parallel"] > 0) == (label.endswith("-mqa")
                                              and shape == (1, 2))
        # MLA sequence parallel on the latent cache's slots at every
        # decode step where ``model`` splits them, and never at prefill
        want = ranks.MESH_T * case["layers"] if label == "deepseek-v2-236b" \
            and shape[1] == 2 else 0
        assert case["mla_seq_parallel"] == [1] * want
        for plain, sharded, ref in zip(case["plain"], case["sharded"],
                                       refs[label]):
            np.testing.assert_allclose(sharded, plain, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(plain, ref, rtol=0, atol=2e-4)
            assert np.array_equal(np.argmax(sharded, -1),
                                  np.argmax(ref, -1))
        # serve.generate on the mesh: its ring caches DTensors, its ids
        # and logits whole
        (ids1, lg1), (ids2, lg2) = case["generate"]
        assert np.array_equal(ids2, ids1)
        for a, b in zip(lg2, lg1):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_mla_decode_sends_no_cache(groups):
    """One decode step of deepseek-v2 on (1, 2) under ``StepCounter``
    (fp32, 4 rows, a cache of 10 slots, 5 a rank): no collective takes a
    block of the latent cache, and what the sequence-parallel MLA sends a
    layer is, by hand, with P = 2 ranks of ``model`` and H / 2 heads a
    rank: the all-gathers of ``q_abs`` (B, 1, H/2, r) and of ``q_rope``
    (B, 1, H/2, rd), (P - 1) times their bytes; the all-reduces of the
    rows' max and of the sums of exponentials, (B, H, 1, 1) each,
    2(P - 1)/P times theirs; the reduce-scatter of ``o_c`` (B, 1, H, r),
    (P - 1)/P times its bytes."""
    cfg = ranks._mesh_cfg("deepseek-v2-236b", NO_DROPS)
    B, H, r, rd, P = ranks.MESH_B, cfg.num_heads, cfg.kv_lora_rank, \
        cfg.qk_rope_dim, 2
    f32, L = 4, cfg.num_layers
    hand = {"all-gather": L * (P - 1) * B * (H // P) * (r + rd) * f32,
            "all-reduce": L * 2 * (2 * (P - 1) * B * H * f32 // P),
            "reduce-scatter": L * (P - 1) * B * H * r * f32 // P}
    for res in groups["mla_decode"]:             # every rank
        assert res["cache_blocks"] == sorted([
            (B, ranks.MESH_CACHE // P, r), (B, ranks.MESH_CACHE // P, rd)])
        assert res["mla"] == hand
        shapes = {shape for _, shape, _ in res["collectives"]}
        assert not shapes & set(res["cache_blocks"])
        total = res["total"]["bytes_by_kind"]
        assert all(total[k] >= v for k, v in hand.items())


@pytest.fixture(scope="module")
def federated(groups):
    return groups


FEDERATED = [(2, 2), (2, 1, 2), "mqa", (2, 2, 1), "mqa-2x1", "mamba2"]


def _federated_group(federated, shape):
    """The rank results and the mesh shape of a ``FEDERATED`` case."""
    if shape == "mqa":            # sequence-parallel attention on (1, 2)
        return federated["federated_mqa"], (1, 2)
    if shape == "mamba2":         # the head-parallel SSD on (1, 2)
        return federated["federated_ssm"], (1, 2)
    if shape == "mqa-2x1":
        return federated["federated_mqa"], (2, 1)
    return federated["federated"], shape


@pytest.mark.parametrize("shape", FEDERATED)
def test_sharded_federated_step(federated, shape):
    group, shape = _federated_group(federated, shape)
    for res in group:
        got = res["meshes"][shape]
        assert abs(got["loss"] - res["loss"]) <= 1e-6 * abs(res["loss"])
        for a, b in zip(got["params"], res["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        # the selection of the same gradients, whole and as shards
        (s1, t1, f1, m1), (s2, t2, f2, m2) = got["selection"]
        np.testing.assert_allclose(t2, t1, rtol=1e-6)
        near = 0
        for a, b, g1, g2 in zip(s1, s2, m1, m2):
            assert (a is None) == (b is None)
            if a is None:
                np.testing.assert_array_equal(g2, g1)
                continue
            np.testing.assert_allclose(b, a, rtol=1e-6)
            close = np.abs(a - t1[:, None]) <= 1e-6 * np.abs(t1[:, None])
            near += int(np.count_nonzero(close))
            # a kept column keeps its values exactly, a dropped one is 0
            keep = np.broadcast_to(((a >= t1[:, None]) & ~close)[:, None, :],
                                   (a.shape[0], g1.size // g1.shape[-1]
                                    // a.shape[0], a.shape[1]))
            g1 = g1.reshape(keep.shape)
            g2 = g2.reshape(keep.shape)
            drop = np.broadcast_to(((a < t1[:, None]) & ~close)[:, None, :],
                                   keep.shape)
            assert np.array_equal(g2[keep], g1[keep])
            assert not np.any(g2[drop]) and not np.any(g1[drop])
        assert near == 0
        np.testing.assert_allclose(f2, f1, rtol=1e-6)
        # one K1 and one K2 call a leaf table, on plain local shards
        assert got["k1"] == got["k2"] == got["tables"] >= 1
        assert got["kernel_inputs"] == ["Tensor"]
        # the scores' exchange; across pods only the masked sums
        assert got["traffic"]["mesh"][0] > 0
        assert (got["traffic"]["pod"][0] > 0) == (len(shape) == 3)


@pytest.mark.parametrize("shape", FEDERATED)
def test_sharded_compressed_step(federated, shape):
    """The compressed exchange of sharded gradients (module docstring)."""
    group, shape = _federated_group(federated, shape)
    pods = len(shape) == 3
    for res in group:
        want, got = res["compressed"], res["meshes"][shape]["compressed"]
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert got["k1"] == got["k2"] == 0      # plain torch, no kernel
        assert got["near"] == 0                 # no tie at the k-th score
        for scored, exact, rel in got["sums"]:
            assert exact or (pods and not scored and rel <= 1e-6), \
                (scored, rel)
        assert got["sent"]["mesh"] > 0          # the scores' exchange
        assert got["pod_sent"] == got["hand_pod_sent"]
        if pods:
            assert 0 < got["pod_sent"] < got["dense_pod_sent"]
        else:
            assert got["pod_sent"] == got["dense_pod_sent"] == 0


@pytest.fixture(scope="module")
def placements(groups):
    return groups["placements"]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-236b",
                                  "mamba2-2.7b"])
def test_placements_follow_spec_for(placements, arch):
    """Every leaf's DTensor placements on (2, 2) are ``spec_for``'s: a
    dimension the spec gives an axis is ``Shard`` over it, the others
    replicate, and the local shape divides accordingly."""
    names = ("data", "model")
    for spec, place, shape, local in placements[arch]:
        want = [("Replicate",)] * 2
        for d, ax in enumerate(spec):
            if ax is not None:
                want[names.index(ax)] = ("Shard", d)
        assert [tuple(p) for p in place] == want, (spec, place)
        expect = list(shape)
        for d, ax in enumerate(spec):
            if ax is not None:
                expect[d] //= 2
        assert list(local) == expect


@pytest.fixture(scope="module")
def experts(groups):
    return groups["experts"]


@pytest.mark.parametrize("dshard", [False, True])
def test_expert_parallel_moe(experts, dshard):
    """Each rank holds half the experts; its routing tables are one
    device's exactly, the output within 1e-5."""
    E = ranks._mesh_cfg("deepseek-v2-236b", NO_DROPS).num_experts
    for res in experts:
        assert res["experts_local"][0] == E // 2
        plain_route = res["routes"][0]
        route = res["routes"][1 + int(dshard)]
        assert np.array_equal(route[0], plain_route[0])
        assert np.array_equal(route[1], plain_route[1])
        np.testing.assert_allclose(res[dshard], res["plain"], rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    store = tmp_path_factory.mktemp("mesh-store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_shard_fn_is_the_identity_where_nothing_splits(world_one):
    from torch.distributed.tensor import DTensor
    mesh = meshes.make_host_mesh((1, 1), device="cpu")
    shard = rules.make_shard_fn(mesh)
    assert shard.mesh is None
    x = torch.ones((4, 8))
    assert shard(x, ("batch", "none")) is x
    d = DTensor.from_local(x, mesh, rules.placements((None, None), mesh))
    assert shard(d, ("batch", "vocab_act")) is d


def test_from_block_allocates_nothing(world_one):
    """Placing a local block as a DTensor makes no storage: its global
    stride is computed, not read off a tensor of the global shape (a
    meta one would count as memory in ``launch.roofline.StepCounter``'s
    step)."""
    from repro_torch.launch.roofline import StepCounter
    from repro_torch.models.common import from_block
    from torch.distributed.tensor import Replicate
    mesh = meshes.make_host_mesh((1, 1), device="cpu")
    x = torch.ones((2, 0, 3))
    with StepCounter() as c:
        d = from_block(x, mesh, [Replicate(), Replicate()], (2, 0, 3))
        e = from_block(torch.ones(4, 5), mesh, [Replicate(), Replicate()],
                       (4, 5))
    assert (d.stride(), e.stride()) == ((3, 3, 1), (5, 1))
    assert c.peak_bytes == {"cpu": 80}       # e's 4 x 5 fp32 block


def test_kernel_wrappers_refuse_a_dtensor(world_one):
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import channel_norm, select_mask
    mesh = meshes.make_host_mesh((1, 1), device="cpu")
    g = DTensor.from_local(torch.ones((4, 8)), mesh,
                           rules.placements((None, None), mesh))
    with pytest.raises(TypeError, match="local shard"):
        channel_norm.channel_norms_leaves([g])
    with pytest.raises(TypeError, match="local shard"):
        select_mask.select_mask_leaves([(g, torch.zeros(4), torch.zeros(8),
                                         0.0, 0.0)])


def test_a_mesh_is_built_for_its_tensors_device(world_one):
    """The mesh's device type is the one asked for; a tensor of another
    device is refused rather than moved."""
    mesh = meshes.make_host_mesh((1, 1), device="cpu")
    assert mesh.device_type == "cpu"

    class OnCards:                       # a cuda mesh's surface
        device_type = "cuda"
    with pytest.raises(ValueError, match="build the mesh"):
        rules.distribute(torch.ones(2), OnCards(), [])
