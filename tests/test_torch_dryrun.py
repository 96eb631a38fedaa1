"""The port's dry run (``repro_torch.launch.dryrun``) and its H100
roofline (``launch.roofline``), in this process on a ``"fake"`` group of
the production mesh's 256 or 512 ranks, every tensor on the meta device.

Each record must be ``ok`` with its state under one card's 80 GB, its
memory counted (outputs, the step's rise above its state, the peak),
every roofline term positive and a ``dominant`` one; a step over the
meta device allocates nothing.  ``roofline_terms`` is held to values
worked by hand from the H100 table, ``StepCounter``'s collectives and
memory to counts worked by hand, the compressed exchange's bytes
across pods to a hand count from the leaves' local shapes, and mamba2's
federated step to half its plain step's FLOPs a device.
"""
import dataclasses
import json

import pytest
import torch.distributed as dist

from repro_torch import configs
from repro_torch.config import HARDWARE
from repro_torch.launch import dryrun
from repro_torch.comm.collectives import link_bytes
from repro_torch.launch.roofline import StepCounter, roofline_terms
from repro_torch.sharding import mesh as meshes

FAMILIES = ["qwen2-0.5b", "deepseek-v2-236b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "whisper-medium", "llama-3.2-vision-11b",
            "llama4-maverick-400b-a17b"]


@pytest.fixture(scope="module", autouse=True)
def fake_group_torn_down():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _smoke(arch):
    return configs.smoke_variant(configs.get(arch))


def _check(rec):
    assert rec["ok"], rec.get("traceback", rec.get("error"))
    assert 0 < rec["state_bytes_per_dev"] < HARDWARE.hbm_bytes
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == rec["state_bytes_per_dev"]
    assert mem["output_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert rec["peak_bytes_per_dev"] == mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"]
    terms = rec["terms"]
    assert terms["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert min(terms["compute_s"], terms["memory_s"],
               terms["collective_s"]) > 0
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values()) > 0
    assert rec["hardware"] == HARDWARE.name
    json.dumps(rec)                       # a record is plain JSON


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_families_decode(arch, mesh):
    """One decode step of each family's smoke variant at decode_32k's
    batch and cache on the production mesh."""
    rec = dryrun.dryrun_one(arch, "decode_32k", mesh, cfg=_smoke(arch))
    _check(rec)
    assert rec["chips"] == (512 if mesh == "multi" else 256)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_smoke_train_step(mesh):
    """A train step of qwen2's smoke variant at train_4k: plain SGD on
    (16, 16); on (2, 16, 16) SCBF's federated step, a client a pod, whose
    channel-masked exchange is the only traffic across pods, and whose
    score exchange runs inside the pod."""
    cfg = dataclasses.replace(_smoke("qwen2-0.5b"))
    rec = dryrun.dryrun_one("qwen2-0.5b", "train_4k", mesh, cfg=cfg)
    _check(rec)
    assert rec["federated"] == (mesh == "multi")
    if mesh == "multi":
        assert rec["collectives"]["cross_pod_bytes"] > 0
    else:
        assert rec["collectives"]["cross_pod_bytes"] == 0


def test_mamba2_federated_flops_are_a_device_share():
    """mamba2's smoke variant at train_4k: a device of the federated step
    on (2, 16, 16) holds 8 rows of a pod's client where a device of the
    plain step on (16, 16) holds 16, so it counts half the FLOPs.  (A
    layer whose input arrived as a partial sum over ``model`` once had
    DTensor run its projections on gathered weights on every ``model``
    rank: 1.04 of the plain step's FLOPs here, 5.0 at full width.)"""
    cfg = _smoke("mamba2-2.7b")
    one = dryrun.dryrun_one("mamba2-2.7b", "train_4k", "single", cfg=cfg)
    fed = dryrun.dryrun_one("mamba2-2.7b", "train_4k", "multi", cfg=cfg)
    for rec in (one, fed):
        _check(rec)
    assert fed["federated"] and not one["federated"]
    assert 2 * fed["flops_per_dev"] == one["flops_per_dev"]


def test_compressed_cross_pod_bytes_by_hand():
    """A smoke-width ``--compressed`` train step on (2, 16, 16), a client
    a pod: the bytes a rank sends across pods (P = 2: an all-gather
    sends the other pod its buffer, an all-reduce 2·(P-1)/P of its
    input) by hand from the leaves' local shards — the loss's fp32 sum;
    each vector leaf's fp32 sum; each scored leaf's int64 indices and
    fp32 values of k = max(1, int(0.1·n)) channels where its columns are
    whole, and where they split, a count of 8 bytes and the expected
    share ceil(k·n_local/n) of them (meta tensors hold no scores) — and
    under the dense exchange's."""
    from repro_torch.models import transformer as T
    from repro_torch.params import tree_leaves
    from repro_torch.sharding.rules import distribute_params
    cfg = _smoke("qwen2-0.5b")
    dense = dryrun.dryrun_one("qwen2-0.5b", "train_4k", "multi", cfg=cfg)
    rec = dryrun.dryrun_one("qwen2-0.5b", "train_4k", "multi",
                            compressed=True, cfg=cfg)
    _check(rec)
    assert rec["compressed"] and rec["federated"] and \
        "ceil" in rec["compact_entries"]
    mesh = meshes.make_production_mesh(multi_pod=True, device="cpu")
    params, axes = T.init_model(cfg, None)
    hand = 4
    for p in tree_leaves(distribute_params(params, axes, mesh)):
        local = p.to_local()
        if p.ndim < 2:
            hand += 4 * local.numel()
            continue
        n, n_local = p.shape[-1], local.shape[-1]
        k, rows = max(1, int(0.1 * n)), local.numel() // n_local
        if n_local == n:
            hand += k * (8 + 4 * rows)
        else:
            hand += 8 + -(-k * n_local // n) * (8 + 4 * rows)
    assert rec["collectives"]["cross_pod_bytes"] == hand
    assert hand < dense["collectives"]["cross_pod_bytes"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_step_counter_memory_by_hand(device):
    """``StepCounter``'s memory on a chain of ops, by device type: the
    state at entry counts nothing; a view and in-place ops add nothing;
    a temporary counts while it is held and gives its bytes back when
    freed; the peak is the most held at once; a storage on another
    device type counts there."""
    import torch
    x = torch.ones((256, 64), device=device)      # state: 65,536 B
    with StepCounter() as c:
        y = x * 2
        v = y.view(64, 256).t()
        assert (c.live_bytes, c.peak_bytes) == ({device: 65_536},) * 2
        z = y + 1
        del y, v                                  # y's storage freed
        assert (c.live_bytes, c.peak_bytes) == ({device: 65_536},
                                                {device: 131_072})
        z.sum(0)                                  # 256 B, dropped
        z.add_(1)
        x.mul_(2)
        w = z.sum(1)                              # 1,024 B, kept
        other = "meta" if device == "cpu" else "cpu"
        shape = torch.empty((1024, 1024), device=other).stride()
    assert c.live_bytes == {device: 65_536 + 1_024, other: 0}
    assert c.peak_bytes == {device: 131_072, other: 4 << 20}
    assert w.shape == (256,) and shape == (1024, 1)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_step_counter_takes_a_wrapper_as_its_outputs(device):
    """Off the card the kernel wrappers run their plain versions, whose
    temporaries the kernels never allocate: K1's call counts its fp32
    (S, M) and (S, N) norms only, where the plain version alone holds a
    slot's fp32 squares (M·N·4 bytes) too; K2's its g̃, mask and int32
    counts."""
    import torch
    from repro_torch.kernels import channel_norm, select_mask
    g = torch.ones((3, 256, 64), device=device)
    with StepCounter() as c:
        channel_norm.channel_norms_leaves([g])
    assert c.peak_bytes == {device: 3 * (256 + 64) * 4}
    with StepCounter() as c:
        channel_norm.channel_norms_plain(g)
    assert c.peak_bytes[device] >= 256 * 64 * 4
    leaf = (g, torch.zeros(256, device=device),
            torch.zeros((3, 64), device=device), 0.0, 0.0)
    with StepCounter() as c:
        got = select_mask.select_mask_leaves([leaf])
    assert c.peak_bytes == c.live_bytes == \
        {device: 3 * 256 * 64 * (4 + 1) + 3 * 4}
    assert got[2].shape == (3,)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_qwen2_full_width_decode(mesh, tmp_path):
    """qwen2-0.5b uncut at decode_32k through the CLI: the record file,
    per-device state that is a 256th (a 512th with pods, each pod taking
    half the batch) of the params and the cache, give or take the
    replicated leaves."""
    recs = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--mesh", mesh, "--out", str(tmp_path)])
    rec = json.loads((tmp_path / f"qwen2-0.5b_decode_32k_{mesh}.json")
                     .read_text())
    assert rec == json.loads(json.dumps(recs[0]))
    _check(rec)
    cfg = configs.get("qwen2-0.5b")
    cache = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads * \
        cfg.head_dim * 2
    assert rec["state_bytes_per_dev"] > (cfg.param_count() * 2 + cache) \
        / 512


def test_a_failure_is_recorded():
    rec = dryrun.dryrun_one("no-such-arch", "decode_32k", "single")
    assert not rec["ok"] and "no-such-arch" in rec["error"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_a_card_unless_asked(monkeypatch, multi_pod):
    """Given no device, ``make_production_mesh`` takes cuda and raises
    without a card; the dry run asks for the CPU."""
    import torch
    dryrun.fake_group(512 if multi_pod else 256)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        meshes.make_production_mesh(multi_pod=multi_pod)
    assert meshes.make_production_mesh(
        multi_pod=multi_pod, device="cpu").device_type == "cpu"


def test_roofline_terms_by_hand():
    """1e12 bf16 FLOPs, 3.35e9 bytes, 9e8 collective bytes sent of which
    5e8 cross nodes: compute 1e12 / 989e12, memory 1 ms, collective
    4e8 / 450e9 (NVLink's 900 GB/s both ways, half of it each way) +
    5e8 / 50e9."""
    t = roofline_terms(1e12, 3.35e9, 9e8, cross_node_bytes=5e8)
    assert t["compute_s"] == pytest.approx(1e12 / 989e12, rel=1e-12)
    assert t["memory_s"] == pytest.approx(1e-3, rel=1e-12)
    assert t["collective_s"] == pytest.approx(4e8 / 450e9 + 5e8 / 50e9,
                                              rel=1e-12)
    assert t["dominant"] == "collective_s"
    assert t["bound_fraction"] == pytest.approx(
        t["compute_s"] / t["collective_s"], rel=1e-12)
    f32 = roofline_terms(67e12, 0.0, 0.0, dtype="float32")
    assert f32["compute_s"] == pytest.approx(1.0, rel=1e-12)
    assert f32["dominant"] == "compute_s" and f32["bound_fraction"] == 1.0
    assert (HARDWARE.nvlink_bw, HARDWARE.nic_bw, HARDWARE.gpus_per_node) \
        == (900e9, 50e9, 8)


def _meta(mesh, local, place, shape):
    """A DTensor of ``shape`` on ``mesh`` whose local shard is ``local``
    (an fp32 shape on the meta device)."""
    import torch
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(torch.empty(local, device="meta"), mesh, place,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def test_step_counter_by_hand():
    """``StepCounter`` on the (16, 16) production mesh, fp32, against
    counts worked by hand.  A (4096 x 896) . (896 x 4864) product with
    the rows over ``data`` and the weight FSDP over ``data`` and split on
    its columns over ``model``: 2·4096·896·4864 / 256 FLOPs a device,
    whatever collective DTensor picks.  Then each kind of collective
    once, with the bytes a rank sends in a ring of 16: the FSDP
    all-gather of the weight's (56, 304) shard sends the other 15
    shards; an all-reduce of a (256, 304) partial sum 2·15/16 of it; a
    reduce-scatter of it 15/16; an all-to-all of the (256, 896) rows
    (rows to columns over ``data``) 15/16."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dryrun.fake_group(256)
    mesh = meshes.make_production_mesh(device="cpu")
    x = _meta(mesh, (256, 896), [Shard(0), Replicate()], (4096, 896))
    w = _meta(mesh, (56, 304), [Shard(0), Shard(1)], (896, 4864))
    with StepCounter(mesh) as c:
        x @ w
    assert c.flops == 2 * 4096 * 896 * 4864 // 256 == 139_460_608

    shard, rows = 56 * 304 * 4, 256 * 304 * 4
    with StepCounter(mesh) as c:
        wg = w.redistribute(mesh, [Replicate(), Shard(1)])
        y = x @ wg
    assert c.bytes_by_kind == {"all-gather": 15 * shard}
    assert c.flops == 2 * 256 * 896 * 304
    assert y.placements == (Shard(0), Shard(1))
    part = _meta(mesh, (256, 304), [Shard(0), Partial()], (4096, 304))
    with StepCounter(mesh) as c:
        part.redistribute(mesh, [Shard(0), Replicate()])
    assert c.bytes_by_kind == {"all-reduce": 2 * 15 * rows // 16}
    with StepCounter(mesh) as c:
        part.redistribute(mesh, [Shard(0), Shard(1)])
    assert c.bytes_by_kind == {"reduce-scatter": 15 * rows // 16}
    with StepCounter(mesh) as c:
        x.redistribute(mesh, [Shard(1), Replicate()])
    assert c.bytes_by_kind == {"all-to-all": 15 * 256 * 896 * 4 // 16}
    assert c.count_by_kind == {"all-to-all": 1}
    assert c.total_bytes == c.cross_node_bytes          # 16 > 8 a node
    assert c.cross_pod_bytes == 0
    assert link_bytes("broadcast", 100, 16) == 100
