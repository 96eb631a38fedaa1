"""The pod axis of the port on gloo CPU groups: ``repro_torch.launch.mesh``
(meshes, collectives, ``spawn_ranks``), ``repro_torch.sharding.rules``,
the batched engine's slot split, ``run_federated`` and the federated LM
step over ranks.

The reference's pod tests (``tests/test_fed_engine.py::
test_pod_sharded_round_matches_single_device`` and ``tests/
test_fused_rounds.py::test_fused_chunk_pod_sharded_matches_single_device``)
promise uploads bitwise those of one device; their scripts are
transcribed here.  Each group is a few spawned ranks (``spawn_ranks``,
60 s process-group timeout, 240 s join), and each rank runs the
one-device counterpart in its own process, so the comparison is within
one process: uploads, records and final weights bitwise.  The LM step's
pod exchange sums in another order: losses within 1e-6 relative, fp32
params within rtol 1e-6 (atol 1e-9), bf16 params within one bf16 ulp.
Its one-pod form is held to the reference's step at
``tests/test_torch_distributed.py``'s fp32 tolerances (loss 1e-5
relative, params 1e-5).  ``spec_for`` is the reference's on every leaf of
every assigned config at full width (meta-device shapes).
"""
import dataclasses
import datetime
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.config import HARDWARE as REF_HARDWARE
from repro.config import MeshConfig as RefMeshConfig
from repro.config import ScbfConfig as RefScbf
from repro.core import distributed as ref_dist
from repro.models import model_zoo as ref_zoo
from repro.sharding import rules as ref_rules
from repro_torch import config as tcfg
from repro_torch import configs as port_configs
from repro_torch.comm import wire
from repro_torch.config import ScbfConfig
from repro_torch.core import distributed as port_dist
from repro_torch.launch import mesh as pod
from repro_torch.sharding import mesh as meshes
from repro_torch.models import transformer as PT
from repro_torch.params import from_numpy_tree, tree_leaves, tree_paths
from repro_torch.sharding import rules

import _torch_pod_ranks as ranks

GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0


def _spawn(fn, world, *args):
    return pod.spawn_ranks(fn, world, args, device="cpu",
                           timeout_s=GROUP_TIMEOUT_S,
                           join_timeout_s=JOIN_TIMEOUT_S)


@pytest.fixture(scope="module")
def engine_groups():
    return {world: _spawn(ranks.engine_contracts, world) for world in (2, 4)}


@pytest.fixture(scope="module")
def run_group():
    return _spawn(ranks.run_cases, 2, list(ranks.RUNS))


@pytest.fixture(scope="module")
def lm_group():
    out = _spawn(ranks.lm_cases, 2, ("float32", "bfloat16"))
    return {dtype: [res[dtype] for res in out]
            for dtype in ("float32", "bfloat16")}


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    """A gloo group of one rank in this process, torn down after the
    module (nothing else here initialises one)."""
    store = tmp_path_factory.mktemp("pod-store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _same_payloads(a, b):
    assert [p.nbytes for p in a] == [p.nbytes for p in b]
    for pa, pb in zip(a, b):
        assert [lp.codec for lp in pa.layers] == [lp.codec for lp in pb.layers]
        for la, lb in zip(wire.decode(pa), wire.decode(pb)):
            assert la.keys() == lb.keys()
            for k in la:
                np.testing.assert_array_equal(la[k].numpy(), lb[k].numpy())


def _same_stats(a, b):
    assert [dataclasses.asdict(s) for s in a] == \
        [dataclasses.asdict(s) for s in b]


# ---------------------------------------------------------------------------
# the reference's two pod contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_pod_sharded_round_matches_single_device(engine_groups, world):
    """A round of P in {1, 3, 4} participants split over ``world`` pods
    ships bit-identical uploads (and upload statistics) to one device's,
    on every rank."""
    for res in engine_groups[world]:
        assert [p for p, _, _ in res["rounds"]] == [1, 3, 4]
        for _, (p1, s1), (pw, sw) in res["rounds"]:
            _same_payloads(p1, pw)
            _same_stats(s1, sw)
    first = engine_groups[world][0]["rounds"]
    for res in engine_groups[world][1:]:
        for (_, (pa, _), _), (_, (pb, _), _) in zip(first, res["rounds"]):
            _same_payloads(pa, pb)


@pytest.mark.parametrize("world", [2, 4])
def test_fused_chunk_pod_sharded_matches_single_device(engine_groups, world):
    """A fused chunk of rounds [0..3], [0, 2] and an empty one, its slot
    axis split over ``world`` pods (B a multiple of the pods), ships
    one device's uploads and ends at one device's model, bitwise."""
    for res in engine_groups[world]:
        (e1, p1, b1), (ew, pw, bw) = res["fused"]["one"], res["fused"]["many"]
        assert b1 == 4 and bw % world == 0
        assert [len(p) for p, _ in ew] == [4, 2, 0]
        for (a, sa), (b, sb) in zip(e1, ew):
            _same_payloads(a, b)
            _same_stats(sa, sb)
        for la, lb in zip(p1, pw):
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k])


@pytest.mark.parametrize("world", [2, 4])
def test_only_masked_deltas_and_masks_cross(engine_groups, world):
    """Every tensor a rank puts into a collective, per round and fused, is
    a slot-stacked masked delta zero outside the mask gathered with it,
    or that mask: no raw delta, no cohort row and no channel score
    crosses.  The traffic counters saw the per-round gathers."""
    for res in engine_groups[world]:
        for key in ("privacy", "fused_privacy"):
            chk = res[key]
            assert chk["bad"] == [] and chk["others"] == []
            assert chk["checked"] >= 4 and chk["masked_out"] > 0
            # masked deltas and their masks, nothing else
            assert chk["calls"] == 2 * chk["checked"]
        calls, nbytes = res["traffic"]
        assert calls == res["privacy"]["calls"] and nbytes > 0


# ---------------------------------------------------------------------------
# run_federated at pods = 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", list(ranks.RUNS))
def test_run_federated_matches_one_device(run_group, label):
    """``run_federated`` at ``pods = 2`` (5 clients: 6 slots, 3 a rank)
    gives one device's records — bytes, upload fractions, AUC, hidden
    sizes, ε, the collected loss — and final weights bitwise, on both
    ranks alike."""
    for res in run_group:
        (rec1, par1), (rec2, par2) = res[label]
        assert rec1 == rec2
        assert len(rec1) == ranks.RUNS[label][1].global_loops
        for la, lb in zip(par1, par2):
            assert la.keys() == lb.keys()
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k])
    assert run_group[0][label][1][0] == run_group[1][label][1][0]


def test_pod_refusals_in_a_group(run_group):
    """The sequential engine refuses pods with the reference's
    ``ValueError``; pods other than the world size fail in the
    reference's words."""
    for res in run_group:
        kind, msg = res["refusals"]["sequential"]
        assert kind == "ValueError" and "single-device" in msg
        kind, msg = res["refusals"]["world"]
        assert kind == "RuntimeError" and \
            msg.startswith("need 3 devices for a pod mesh, have 2")


def test_pods_without_a_group_are_refused():
    with pytest.raises(RuntimeError, match="need 2 devices for a pod mesh, "
                                           "have 0"):
        meshes.make_pod_mesh(2)
    with pytest.raises(RuntimeError, match=r"need 256 devices for mesh "
                                           r"\(16, 16\), have 0"):
        meshes.make_production_mesh()
    with pytest.raises(RuntimeError, match=r"need 512 devices for mesh "
                                           r"\(2, 16, 16\)"):
        meshes.make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("a,e", [(0, 1), (0, 2), (0, 12), (12, 24),
                                 (3, 5)])
def test_a_slot_range_alone_is_those_slots_of_the_whole_pass(a, e):
    """A pod rank's share of a round: ``_slot_pass`` (DP and the carry on)
    over slots [a, e) of a 24-slot round alone gives those slots of the
    whole pass bitwise — masked deltas, masks and carry — whatever the
    range's size against ``SLOT_CHUNK``."""
    from repro_torch.fed.engine import BatchedEngine, _slot_pass
    from repro_torch.models.mlp_net import init_mlp
    rng = np.random.default_rng(0)
    shards = [(rng.random((int(n), 33)).round().astype(np.float32),
               (rng.random(int(n)) > 0.5).astype(np.float32))
              for n in rng.integers(20, 40, 24)]
    eng = BatchedEngine(shards, 8, 2, "cpu")
    params = init_mlp((33, 16, 8, 1), torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    perms = [[torch.randperm(eng.perm_length(k), generator=gen)
              for _ in range(2)] for k in range(24)]
    rows, valid, pm = eng._slot_inputs(np.arange(24), perms, 24)
    noise = eng.draw_noise(params, 24, generator=gen)
    cfg = ScbfConfig(upload_rate=0.2, dp_noise_multiplier=1.0,
                     dp_clip_norm=1.0)

    def run(lo, hi):
        masked, masks, met = _slot_pass(
            params, eng.cohort, rows[lo:hi], valid[lo:hi], 0.05,
            pm[lo:hi], cfg, batch_size=8, epochs=2,
            noise=[z[lo:hi] for z in noise], collect=True)
        return [t for layer in masked for t in layer.values()] + \
            [t for layer in masks for t in layer.values()
             if t is not None] + list(met)

    whole, part = run(0, 24), run(a, e)
    assert len(part) == len(whole)
    for w, g in zip(whole, part):
        assert torch.equal(w[a:e], g)


def test_slot_chunked_pads_and_cuts_back():
    from repro_torch.slots import SLOT_CHUNK, slot_chunked
    seen = []

    def fn(x, y):
        seen.append(x.shape[0])
        return x * 2 + y

    for s in (1, SLOT_CHUNK, SLOT_CHUNK + 3):
        x, y = torch.randn(s, 3, 2), torch.randn(s, 3, 2)
        seen.clear()
        assert torch.equal(slot_chunked(fn, x, y), x * 2 + y)
        assert seen == [SLOT_CHUNK] * (-(-s // SLOT_CHUNK))


def test_spawn_ranks_raises_when_a_rank_fails():
    """A rank that raises fails the group (whichever rank's failure is
    seen first: the one that raised, or a peer whose barrier lost it),
    the others terminated."""
    from torch.multiprocessing.spawn import ProcessException
    with pytest.raises(ProcessException):
        pod.spawn_ranks(ranks.fail_on_last, 2, device="cpu", timeout_s=20.0,
                        join_timeout_s=60.0)


# ---------------------------------------------------------------------------
# the federated LM step over pods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compressed", [False, True],
                         ids=["dense", "compressed"])
def test_federated_lm_step_over_pods(lm_group, dtype, compressed):
    """One step of the qwen2 smoke variant, K = 4 clients split 2 and 2,
    against the one-device step of the same batch: the loss within 1e-6
    relative, fp32 params within rtol 1e-6 (atol 1e-9), bf16 params
    within one bf16 ulp; the same dtypes; both ranks alike."""
    for res in lm_group[dtype]:
        r = res[compressed]
        l1, lp = r["loss"]
        assert lp == pytest.approx(l1, rel=1e-6)
        assert r["dtypes"][0] == r["dtypes"][1]
        for a, b in zip(*r["params"]):
            if dtype == "float32":
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
            else:
                ulp = np.spacing(np.abs(a).astype(np.float32)) * 2.0 ** 16
                ulp = np.maximum(ulp, 2.0 ** -133)
                assert np.all(np.abs(b - a) <= ulp)
    for a, b in zip(lm_group[dtype][0][compressed]["params"][1],
                    lm_group[dtype][1][compressed]["params"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_exchange_crosses_only_masked_or_compact(lm_group, dtype):
    """What enters a collective in the pod step: dense — the loss sum and
    each leaf's fp32 partial sum of the rank's masked clients, bitwise,
    every scored leaf with entries its raw sum has and it hides;
    compressed — ``(idx, vals)`` buffers of fewer channels than the
    leaf, the loss sum and the always-uploaded vectors' sums."""
    for res in lm_group[dtype]:
        dense = res[False]["privacy"]
        assert dense["bad"] == [] and dense["checked"] == dense["leaves"]
        assert 0 < dense["scored_with_hidden_entries"] <= dense["scored"]
        comp = res[True]["privacy"]
        assert comp["bad"] == [] and comp["pairs"] == comp["scored"] > 0
        assert comp["vectors"] >= 1
        assert res[True]["traffic"][1] < res[False]["traffic"][1]


def test_lm_step_refuses_clients_that_do_not_split(lm_group):
    for res in lm_group["float32"]:
        assert res["refusal"] == "3 clients do not split over 2 pods"


def test_one_pod_lm_step_matches_the_reference(world_one):
    """The pod form of the step on a group of one (mesh of 1) and the
    step without a mesh against the reference's
    ``make_federated_train_step``, K = 4: loss 1e-5 relative, params
    1e-5 (fp32, ``tests/test_torch_distributed.py``'s tolerances)."""
    cfg, bundle, _ = ranks.lm_model("float32")
    rb = ref_zoo.build(dataclasses.replace(
        ref_configs.smoke_variant(ref_configs.get("qwen2-0.5b")),
        dtype="float32"))
    rp, _ = rb.init(jax.random.PRNGKey(0))
    params = from_numpy_tree(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    batch = ranks.lm_batch(cfg.vocab_size)
    wl, want = jax.jit(ref_dist.make_federated_train_step(
        rb.loss_fn, RefScbf(upload_rate=0.10), lr=0.05))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mesh = meshes.make_pod_mesh(1, device="cpu")
    for m in (None, mesh):
        gl, got = port_dist.make_federated_train_step(
            bundle.loss_fn, ScbfConfig(upload_rate=0.10), lr=0.05,
            mesh=m)(params, tb)
        assert float(gl) == pytest.approx(float(wl), rel=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# sharding rules against the reference's
# ---------------------------------------------------------------------------

class FakeMesh:
    """Only .shape (and the axis names) is consulted by spec_for."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}
RULES = rules.ShardingRules()


@functools.lru_cache(maxsize=None)
def _meta_leaves(arch):
    params, axes = PT.init_model(port_configs.get(arch), None)
    return [(a, tuple(t.shape)) for (_, a), t in
            zip(tree_paths(axes), tree_leaves(params))]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", port_configs.ASSIGNED)
def test_spec_for_is_the_references_on_every_leaf(arch, mesh):
    """Every leaf of every assigned config at full width (meta-device
    shapes and their logical axes): the port's spec is the reference's
    ``PartitionSpec``, entry for entry; ``param_shardings`` gives the
    same tree."""
    leaves = _meta_leaves(arch)
    ref = ref_rules.ShardingRules()
    for axes, shape in leaves:
        assert RULES.spec_for(axes, shape, MESHES[mesh]) == \
            tuple(ref.spec_for(axes, shape, MESHES[mesh])), (axes, shape)
    params, axes = PT.init_model(port_configs.get(arch), None)
    specs = rules.param_shardings(axes, MESHES[mesh], shapes_tree=params)
    for (path, _), (a, shape) in zip(tree_paths(axes), leaves):
        node = specs
        for key in path:
            node = node[key] if isinstance(node, dict) else node[int(key)]
        assert node == RULES.spec_for(a, shape, MESHES[mesh])


def _spec(axes, shape):
    return RULES.spec_for(axes, shape, MESHES["16x16"])


@pytest.mark.parametrize("axes,shape,want", [
    ("embed,mlp", (5120, 27648), P("data", "model")),
    ("experts,embed,mlp", (160, 5120, 1536), P("model", "data", None)),
    ("vocab,embed", (50280, 2560), P(None, "data")),
    ("vocab,embed", (65536, 2560), P("model", "data")),
    ("embed,heads", (896, 896), P("data", "model")),
    ("none,none", (7, 9), P(None, None)),
], ids=["dense_weight", "expert_priority", "vocab_not_divisible_falls_through",
        "vocab_divisible", "qkv_fused_heads", "small_dim_replicates"])
def test_sharding_cases_of_the_reference(axes, shape, want):
    """``tests/test_sharding.py``'s cases, the reference's spec beside."""
    assert _spec(axes, shape) == tuple(want)
    assert tuple(ref_rules.ShardingRules().spec_for(
        axes, shape, MESHES["16x16"])) == tuple(want)


def test_layers_never_sharded():
    assert _spec("layers,embed,mlp", (24, 1024, 2816))[0] is None


def test_batch_spec_fallbacks():
    mesh = MESHES["2x16x16"]
    assert rules.batch_spec(mesh, 256) == (("pod", "data"),)
    assert rules.batch_spec(mesh, 16) == ("data",)
    assert rules.batch_spec(mesh, 1) == (None,)
    for b in (256, 16, 1):
        assert P(*rules.batch_spec(mesh, b)) == ref_rules.batch_spec(mesh, b)


def test_activation_spec():
    mesh = MESHES["16x16"]
    got = rules.activation_spec(("batch", "none", "kv_seq"),
                                rules.activation_rules(mesh))
    assert got == (("data",), None, ("model",))
    assert P(*got) == P(("data",), None, ("model",)) == \
        ref_rules.activation_spec(("batch", "none", "kv_seq"),
                                  ref_rules.activation_rules(mesh))
    assert rules.activation_rules(MESHES["2x16x16"]) == \
        ref_rules.activation_rules(MESHES["2x16x16"])


def test_host_mesh_constraint_runs(world_one):
    """``ctx.shard`` on a 1 × 1 host mesh (the reference's test of the
    same name, which fails under its jax here): the identity; on a mesh
    with a data or model axis above 1 it places DTensors only, and a
    plain tensor passes through."""
    mesh = meshes.make_host_mesh(device="cpu")
    assert rules.axis_sizes(mesh) == {"data": 1, "model": 1}
    shard = rules.make_shard_fn(mesh)
    x = torch.ones((4, 8))
    y = shard(x, ("batch", "none")) * 2
    np.testing.assert_allclose(y.numpy(), 2.0)
    assert rules.make_shard_fn(MESHES["2x16x16"])(x, ("batch", "none")) is x


def test_federated_placements(world_one):
    """The pod mesh's placements: the slot axis (axis 1 of a fused plan)
    splits into contiguous rank ranges, weights and keep-masks
    replicate; a mesh without ``pod`` is refused as the reference's."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = meshes.make_pod_mesh(1, device="cpu")
    assert rules.cohort_shardings(mesh) == (Shard(0), Replicate())
    assert rules.fused_plan_shardings(mesh) == (Shard(1), Replicate())
    assert rules.keep_mask_sharding(mesh) == Replicate()
    assert rules.slot_range(6, mesh) == (0, 6)
    host = meshes.make_host_mesh(device="cpu")
    for fn in (rules.cohort_shardings, rules.keep_mask_sharding,
               rules.fused_plan_shardings):
        with pytest.raises(ValueError, match="no 'pod' axis"):
            fn(host)
        with pytest.raises(ValueError, match="no 'pod' axis"):
            getattr(ref_rules, fn.__name__)(MESHES["16x16"])


NO_CARD = {
    "spawn_ranks": lambda: pod.spawn_ranks(ranks.fail_on_last, 2),
    "make_pod_mesh": lambda: meshes.make_pod_mesh(1),
    "make_host_mesh": lambda: meshes.make_host_mesh(),
    "make_host_mesh_3d": lambda: meshes.make_host_mesh((1, 1, 1)),
}


@pytest.mark.parametrize("call", list(NO_CARD))
def test_ranks_and_meshes_need_a_card_unless_asked(world_one, monkeypatch,
                                                   call):
    """Given no device, ``spawn_ranks`` and the mesh builders take cuda
    (``repro_torch.device``'s rule) and raise without a card, before a
    rank starts or a mesh is built; only ``device="cpu"`` gives CPU ranks
    and meshes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        NO_CARD[call]()
    if call != "spawn_ranks":
        assert meshes.make_host_mesh(device="cpu").device_type == "cpu"


def test_package_names_are_the_references():
    """``repro_torch.sharding`` re-exports the reference package's names,
    resolved on first use."""
    import repro.sharding
    import repro_torch.sharding as port
    want = {n for n in vars(repro.sharding) if not n.startswith("_")
            and not isinstance(getattr(repro.sharding, n), type(os))}
    assert set(port.__all__) == want
    for name in port.__all__:
        assert getattr(port, name) is getattr(rules, name)


def test_mesh_and_hardware_configs():
    """``MeshConfig`` is the reference's field for field; ``HARDWARE`` is
    the H100's table, none of the reference's TPU figures."""
    for multi in (False, True):
        a, b = tcfg.MeshConfig(multi_pod=multi), RefMeshConfig(multi_pod=multi)
        assert (a.shape, a.axes, a.num_devices) == \
            (b.shape, b.axes, b.num_devices)
    hw = tcfg.HARDWARE
    assert hw.name == "NVIDIA H100 80GB HBM3" and hw.power_limit_w == 700.0
    assert (hw.hbm_bw, hw.peak_fp32, hw.peak_bf16, hw.hbm_bytes) == \
        (3.35e12, 67e12, 989e12, 80e9)
    assert hw.hbm_bw != REF_HARDWARE.hbm_bw and \
        hw.peak_bf16 != REF_HARDWARE.peak_flops
