"""The flight recorder's device layer of the port (``repro_torch.obs.
metrics`` and ``report``) against the reference's (``repro.obs``), the
counterparts of ``tests/test_obs.py``: the telemetry functions on the same
inputs, the device numbers against the wire, training untouched by
collection, a run's event log beside the reference's with its draws
injected, and the report reader.  Small sizes: cohort 600 × 24, MLP
24-8-4-1, 3 clients."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as RefFedConfig
from repro.config import ScbfConfig as RefScbfConfig
from repro.config import TrainConfig as RefTrainConfig
from repro.core import client as ref_client
from repro.core.scbf import run_federated as ref_run
from repro.data.medical import federated_split as ref_split
from repro.data.medical import generate_cohort as ref_cohort
from repro.fed import cohort as ref_cohort_mod
from repro.obs import metrics as ref_obsm
from repro.obs import report as ref_report
from repro.obs import trace as ref_trace
from repro_torch import config as tcfg
from repro_torch.comm import wire
from repro_torch.core import client
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.fed import cohort as cohort_mod
from repro_torch.fed import engine
from repro_torch.obs import metrics as obsm
from repro_torch.obs import report, trace
from repro_torch.params import from_numpy

from _torch_parity import epoch_perms, np_tree, reference_draws

FEATS = (24, 8, 4, 1)
K, BATCH, SEED = 3, 32, 0
REQUIRED_ROUND = {"loop", "participants", "upload_fraction", "sparse_bytes",
                  "dense_bytes", "wall", "wall_is_amortized", "hidden",
                  "evaluated", "sampled", "dropped", "stragglers",
                  "staleness_mean", "staleness_max", "train_loss",
                  "selected", "codec_bytes"}
REQUIRED_FIELDS = {"meta": {"schema", "emitter"},
                   "run_start": {"method", "loops", "clients", "engine",
                                 "fuse_rounds", "mode"},
                   "round": REQUIRED_ROUND, "span": {"name", "dur"},
                   "run_end": set()}
PRUNE = dict(prune=True, prune_rate=0.25, prune_total=0.4,
             prune_impl="mask")


@pytest.fixture(scope="module")
def port_cohort():
    return generate_cohort(num_admissions=600, num_medicines=24, seed=SEED)


def _cfg(fuse=1, loops=2, engine_name="batched", obs=None, debug=False,
         lr=0.05, **scbf):
    return tcfg.TrainConfig(
        learning_rate=lr, global_loops=loops, local_batch_size=BATCH,
        seed=SEED, debug_checks=debug, obs=obs or tcfg.ObsConfig(),
        scbf=tcfg.ScbfConfig(num_clients=K, upload_rate=0.25, **scbf),
        fed=tcfg.FedConfig(fuse_rounds=fuse, engine=engine_name))


def _bitwise(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


# ---------------------------------------------------------------------------
# the telemetry functions against the reference's
# ---------------------------------------------------------------------------

def test_leaf_codec_costs_match_reference():
    rng = np.random.default_rng(0)
    sizes = np.array([1, 7, 8, 9, 64, 1000, 2917 * 256], np.int32)
    nnz = (rng.random(sizes.size) * sizes).astype(np.int32)
    nnz[0], nnz[3] = 0, sizes[3]
    want = np.asarray(ref_obsm.leaf_codec_costs(jnp.asarray(nnz),
                                                jnp.asarray(sizes)))
    for s in (sizes, torch.from_numpy(sizes)):
        got = obsm.leaf_codec_costs(torch.from_numpy(nnz), s)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _slot_tree(b, feats, seed, density, bias=True):
    """(masked, masks) slot-stacked numpy trees: a random mask of the given
    density, values nonzero on it (a slot's zero row where it is padding
    is the caller's)."""
    rng = np.random.default_rng(seed)
    masked, masks = [], []
    for i, o in zip(feats[:-1], feats[1:]):
        mw = rng.random((b, i, o)) < density
        lm = {"w": mw}
        lv = {"w": np.where(mw, rng.standard_normal((b, i, o)) + 2.0,
                            0.0).astype(np.float32)}
        if bias:
            mb = rng.random((b, o)) < density
            lm["b"], lv["b"] = mb, np.where(
                mb, rng.standard_normal((b, o)) + 2.0, 0.0).astype(
                    np.float32)
        else:
            lm["b"] = None
        masked.append(lv)
        masks.append(lm)
    return tuple(masked), tuple(masks)


@pytest.mark.parametrize("density", [0.02, 0.3, 0.95])
@pytest.mark.parametrize("eff", [False, True], ids=["full", "effective"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "bias-free"])
def test_slot_metrics_and_reduce_match_reference(density, eff, bias):
    """``slot_metrics`` of a (B,) round and ``reduce_slots`` == the
    reference's ``jax.vmap`` of ``slot_metrics`` and its ``reduce_slots``:
    integers exact, the loss to 1e-6; a padded slot adds nothing."""
    b, feats = 4, (40, 16, 8, 1)
    masked, masks = _slot_tree(b, feats, 3, density, bias)
    valid = np.array([True, True, True, False])
    for layer_v, layer_m in zip(masked, masks):      # slot 3 is padding
        for k in layer_v:
            layer_v[k][3] = 0.0
            if layer_m[k] is not None:
                layer_m[k][3] = False
    loss = np.random.default_rng(4).random(b).astype(np.float32) + 0.3
    leaves = [(l, k) for l, k in wire.flat_keys(masked)]
    sizes = np.array([masked[l][k][0].size for l, k in leaves], np.int32)
    es = np.maximum(sizes // 2, 1).astype(np.int32) if eff else None
    want_slots = jax.vmap(
        lambda lo, mv, mk, v: ref_obsm.slot_metrics(
            lo, mv, mk, v, eff_sizes=None if es is None
            else jnp.asarray(es)),
        in_axes=(0, 0, 0, 0))(
        jnp.asarray(loss),
        tuple({k: jnp.asarray(v) for k, v in layer.items()}
              for layer in masked),
        tuple({k: None if v is None else jnp.asarray(v)
               for k, v in layer.items()} for layer in masks),
        jnp.asarray(valid))
    got_slots = obsm.slot_metrics(
        torch.from_numpy(loss),
        tuple({k: torch.from_numpy(v) for k, v in layer.items()}
              for layer in masked),
        tuple({k: None if v is None else torch.from_numpy(v)
               for k, v in layer.items()} for layer in masks),
        torch.from_numpy(valid),
        None if es is None else torch.from_numpy(es))
    for got, want in ((got_slots, want_slots),
                      (obsm.reduce_slots(got_slots),
                       ref_obsm.reduce_slots(want_slots))):
        for name in ("participants", "selected", "sparse_bytes",
                     "codec_bytes"):
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert got.loss_sum.dtype == torch.float32
        np.testing.assert_allclose(got.loss_sum.numpy(),
                                   np.asarray(want.loss_sum), rtol=1e-6)


def test_codec_ties_go_to_the_first_in_codecs_order():
    """coo and bitmap cost the same at nnz·4 = ceil(size/8) (size 32, nnz
    1): coo wins, as ``min()`` over ``wire.CODECS`` and the reference's
    ``argmin``."""
    masked = ({"w": torch.zeros(1, 4, 8)},)
    masked[0]["w"][0, 1, 2] = 1.0
    masks = ({"w": masked[0]["w"] != 0, "b": None},)
    got = obsm.slot_metrics(torch.ones(1), masked, masks,
                            torch.ones(1, dtype=torch.bool))
    assert wire.cheapest_bytes(1, 32) == ("coo", 8)
    assert got.codec_bytes.tolist() == [[8, 0, 0]]


@pytest.mark.parametrize("keep", [None, [[0, 2, 5], [1, 3]]],
                         ids=["full", "compacted"])
def test_effective_leaf_sizes_match_reference(keep):
    p0 = np_tree(ref_init((12, 6, 4, 1)))
    want = ref_obsm.effective_leaf_sizes(p0, None if keep is None else
                                         [np.asarray(k) for k in keep])
    got = obsm.effective_leaf_sizes(from_numpy(p0, "cpu"), keep)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    bias_free = tuple(dict(layer, b=None) for layer in p0)
    np.testing.assert_array_equal(
        obsm.effective_leaf_sizes(bias_free, keep),
        ref_obsm.effective_leaf_sizes(bias_free, keep))


def ref_init(feats):
    from repro.models.mlp_net import init_mlp
    return init_mlp(feats, jax.random.PRNGKey(1))


@pytest.mark.parametrize("rounds", [None, 2, 3])
def test_offload_matches_reference(rounds):
    """One offload (one counted host offload) gives the reference's dicts,
    for a round's carry and a stacked chunk's, trimmed to its rounds;
    FedAvg's carry too."""
    rng = np.random.default_rng(5)
    shape = () if rounds is None else (3,)
    fields = dict(
        loss_sum=(rng.random(shape) * 4).astype(np.float32),
        participants=rng.integers(0, 6, shape).astype(np.int32),
        selected=rng.integers(0, 99, shape + (3,)).astype(np.int32),
        sparse_bytes=rng.integers(0, 2 ** 30, shape).astype(np.int32),
        codec_bytes=rng.integers(0, 2 ** 29, shape + (3,)).astype(np.int32))
    for kind, ref_kind, names in (
            (obsm.MetricsCarry, ref_obsm.MetricsCarry, list(fields)),
            (obsm.FedAvgMetrics, ref_obsm.FedAvgMetrics,
             ["loss_sum", "participants"])):
        carry = kind(*(torch.from_numpy(np.asarray(fields[n])) for n in names))
        want_carry = ref_kind(*(jnp.asarray(fields[n]) for n in names))
        with trace.recording() as rec:
            got = obsm.offload(carry, rounds=rounds)
        with ref_trace.recording() as ref_rec:
            want = ref_obsm.offload(want_carry, rounds=rounds)
        assert got == want
        assert rec.counters["host_offloads"] == \
            ref_rec.counters["host_offloads"] == 1


def test_packed_offload_is_one_buffer():
    """The carry crosses as one int32 buffer: its columns are the fields,
    the loss as its bits."""
    carry = obsm.MetricsCarry(torch.tensor([1.5, 2.0]),
                              torch.tensor([3, 1], dtype=torch.int32),
                              torch.tensor([[1, 2], [3, 4]],
                                           dtype=torch.int32),
                              torch.tensor([10, 20], dtype=torch.int32),
                              torch.tensor([[1, 2, 7], [0, 0, 20]],
                                           dtype=torch.int32))
    packed = obsm._pack(carry)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (2, 8)
    assert packed[:, 0].view(torch.float32).tolist() == [1.5, 2.0]
    assert obsm.offload(carry, rounds=2)[1] == {
        "participants": 1, "train_loss": 2.0, "selected": [3, 4],
        "sparse_bytes": 20, "codec_bytes": {"coo": 0, "bitmap": 0,
                                            "dense": 20}}


# ---------------------------------------------------------------------------
# device metrics against the wire
# ---------------------------------------------------------------------------

def _tiny_engine(kind="batched", k=6, n=48, d=12, seed=0):
    rng = np.random.default_rng(seed)
    clients = [((rng.random((n, d)) < 0.3).astype(np.float32),
                (rng.random(n) < 0.5).astype(np.float32)) for _ in range(k)]
    eng = engine.make_engine(kind, clients, 16, 1, "cpu")
    params = from_numpy(np_tree(ref_init((d, 8, 4, 1))), "cpu")
    perms = [[np.random.default_rng(100 + c).permutation(
        eng.perm_length(c))] for c in range(k)]
    return eng, params, perms


@pytest.mark.parametrize("kind", ["batched", "sequential"])
@pytest.mark.parametrize("case", ["plain", "mask-mode", "dp"])
def test_device_metrics_match_wire_truth(kind, case):
    """The round's telemetry IS the wire's: sparse bytes and the codec
    breakdown equal the encoded payloads' exactly — under mask mode's
    effective-geometry emission and under DP too."""
    eng, params, perms = _tiny_engine(kind)
    part = np.array([0, 1, 3, 4, 5])               # 5 of 6: a padded slot
    kw, cfg = {}, tcfg.ScbfConfig(upload_rate=0.25, num_clients=6)
    if case == "mask-mode":
        nm = (torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.float32),
              torch.tensor([1, 1, 0, 1], dtype=torch.float32))
        kw = dict(nmasks=nm, keep=[np.array([0, 2, 3, 5, 6, 7]),
                                   np.array([0, 1, 3])])
    if case == "dp":
        cfg = dataclasses.replace(cfg, dp_noise_multiplier=0.5)
        kw = dict(dp_generator=torch.Generator().manual_seed(3))
    payloads, _, dm = eng.scbf_round(params, part, 0.05,
                                     [perms[c] for c in part], cfg,
                                     generator=torch.Generator(),
                                     collect=True, **kw)
    assert dm["participants"] == len(payloads) == part.size
    assert dm["sparse_bytes"] == sum(p.nbytes for p in payloads)
    assert dm["codec_bytes"] == wire.codec_breakdown(payloads)
    assert sum(dm["codec_bytes"].values()) == dm["sparse_bytes"]
    assert dm["train_loss"] > 0.0
    if kind == "batched":
        assert len(dm["selected"]) == len(params)
        assert all(s >= 0 for s in dm["selected"])


@pytest.mark.parametrize("kind", ["batched", "sequential"])
def test_empty_round_collect_shape(kind):
    eng, params, _ = _tiny_engine(kind)
    cfg = tcfg.ScbfConfig(upload_rate=0.25, num_clients=6)
    got = eng.scbf_round(params, np.array([], np.int64), 0.05, [], cfg,
                         collect=True)
    fa = eng.fedavg_round(params, np.array([], np.int64), 0.05, [],
                          collect=True)
    assert got[:2] == ([], []) and fa[0] == []
    if kind == "batched":
        assert got[2] is None and fa[2] is None
    else:
        # the reference's sequential engine reads an empty round's
        # (zero) numbers from its no payloads
        assert got[2]["participants"] == fa[2]["participants"] == 0


# ---------------------------------------------------------------------------
# with_loss: training untouched, the reference's loss
# ---------------------------------------------------------------------------

def _shards(sizes, seed=1, d=FEATS[0]):
    rng = np.random.default_rng(seed)
    return [((rng.random((n, d)) < 0.2).astype(np.float32),
             (rng.random(n) < 0.4).astype(np.float32)) for n in sizes]


@pytest.mark.parametrize("trainer", ["plain", "masked", "slots",
                                     "slots-masked"])
def test_with_loss_leaves_params_bitwise_and_matches_reference(trainer):
    """``with_loss`` returns the params of the run without it bitwise, and
    the reference's mean loss (plain: over the steps; masked: example-
    weighted) to 1e-6 on the same permutations."""
    p0 = np_tree(ref_init(FEATS))
    epochs, batch = 2, 32
    if trainer in ("plain", "masked"):
        (x, y), = _shards([130])
        w = (np.arange(130) < 97).astype(np.float32)
        key = jax.random.PRNGKey(7)
        perms = epoch_perms(key, 130, epochs)
        args = (from_numpy(p0, "cpu"), torch.from_numpy(x),
                torch.from_numpy(y))
        if trainer == "plain":
            plain = client.local_train_impl(*args, 0.05, perms=perms,
                                            batch_size=batch, epochs=epochs)
            got, loss = client.local_train_impl(
                *args, 0.05, perms=perms, batch_size=batch, epochs=epochs,
                with_loss=True)
            _, want = ref_client.local_train_impl(
                p0, jnp.asarray(x), jnp.asarray(y), 0.05, key,
                batch_size=batch, epochs=epochs, with_loss=True)
        else:
            plain = client.masked_local_train_impl(
                *args, torch.from_numpy(w), 0.05, perms=perms,
                batch_size=batch, epochs=epochs)
            got, loss = client.masked_local_train_impl(
                *args, torch.from_numpy(w), 0.05, perms=perms,
                batch_size=batch, epochs=epochs, with_loss=True)
            _, want = ref_client.masked_local_train_impl(
                p0, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), 0.05,
                key, batch_size=batch, epochs=epochs, with_loss=True)
        assert _bitwise(plain, got)
        assert loss.dim() == 0 and loss.dtype == torch.float32
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
        return
    masked = trainer == "slots-masked"
    sizes = (130, 97, 130) if masked else (130, 130, 130)
    clients = _shards(sizes)
    padded = ref_cohort_mod.pad_clients(clients)
    keys = jax.random.split(jax.random.PRNGKey(5), len(sizes))
    if masked:
        _, want = jax.vmap(lambda x, y, w, k:
                           ref_client.masked_local_train_impl(
                               p0, x, y, w, 0.05, k, batch_size=batch,
                               epochs=epochs, with_loss=True))(
            padded.x, padded.y, padded.w, keys)
    else:
        _, want = jax.vmap(lambda x, y, k: ref_client.local_train_impl(
            p0, x, y, 0.05, k, batch_size=batch, epochs=epochs,
            with_loss=True))(padded.x, padded.y, keys)
    perms = np.stack([np.stack(epoch_perms(k, padded.n_max, epochs))
                      for k in keys])
    s = len(sizes)
    start = tuple({k: v.unsqueeze(0).expand(s, *v.shape)
                   for k, v in layer.items()} for layer in from_numpy(p0,
                                                                      "cpu"))
    port = cohort_mod.pad_clients(clients)
    kw = dict(w=port.w if masked else None, batch_size=batch, epochs=epochs)
    plain = client.local_train_slots(start, port.x, port.y, 0.05, perms,
                                     **kw)
    got, loss = client.local_train_slots(start, port.x, port.y, 0.05, perms,
                                         with_loss=True, **kw)
    assert _bitwise(plain, got)
    assert tuple(loss.shape) == (s,) and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# driver level: collection changes no bit, the losses agree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,fuse,scbf", [
    ("scbf-per-round", 1, {}),
    ("scbf-fused", 2, {}),
    ("scbfwp-mask-fused", 2, PRUNE),
])
def test_telemetry_does_not_change_the_trajectory(port_cohort, case, fuse,
                                                  scbf):
    """Device metrics on: params bitwise, bytes, upload fractions and AUC
    equal; ``train_loss`` filled only with collection on."""
    loops = 4
    plain = run_federated(port_cohort, _cfg(fuse, loops, **scbf),
                          mlp_features=FEATS, device="cpu")
    obs = run_federated(port_cohort, _cfg(fuse, loops,
                                          obs=tcfg.ObsConfig(
                                              device_metrics=True), **scbf),
                        mlp_features=FEATS, device="cpu")
    assert _bitwise(plain.final_params, obs.final_params)
    for a, b in zip(plain.records, obs.records):
        assert (a.sparse_bytes, a.upload_fraction, a.auc_roc,
                a.hidden_sizes) == (b.sparse_bytes, b.upload_fraction,
                                    b.auc_roc, b.hidden_sizes)
        assert a.train_loss is None
        assert b.train_loss is not None and b.train_loss > 0
    assert plain.telemetry is None and obs.telemetry is None


@pytest.mark.parametrize("method", ["scbf", "fedavg"])
def test_fused_loss_matches_per_round_loss(port_cohort, method):
    obs = tcfg.ObsConfig(device_metrics=True)
    a = run_federated(port_cohort, _cfg(1, 4, obs=obs), method=method,
                      mlp_features=FEATS, device="cpu")
    b = run_federated(port_cohort, _cfg(2, 4, obs=obs), method=method,
                      mlp_features=FEATS, device="cpu")
    for ra, rb in zip(a.records, b.records):
        assert ra.train_loss == pytest.approx(rb.train_loss, rel=1e-6)


@pytest.mark.parametrize("engine_name", ["batched", "sequential"])
def test_fedavg_collects_its_round_loss(port_cohort, engine_name):
    obs = tcfg.ObsConfig(device_metrics=True)
    res = run_federated(port_cohort, _cfg(1, 2, engine_name, obs=obs),
                        method="fedavg", mlp_features=FEATS, device="cpu")
    assert all(r.train_loss is not None and r.train_loss > 0
               for r in res.records)


def test_recording_off_leaves_no_telemetry(port_cohort):
    """Recording off and device metrics off: no telemetry, no loss; device
    metrics on without a recorder: the loss, still no telemetry."""
    off = run_federated(port_cohort, _cfg(2, 2), mlp_features=FEATS,
                        device="cpu")
    assert off.telemetry is None
    assert all(r.train_loss is None for r in off.records)
    on = run_federated(port_cohort, _cfg(2, 2, obs=tcfg.ObsConfig(
        device_metrics=True)), mlp_features=FEATS, device="cpu")
    assert on.telemetry is None
    assert all(r.train_loss is not None for r in on.records)


# ---------------------------------------------------------------------------
# a recorded run beside the reference's, its draws injected
# ---------------------------------------------------------------------------

def _kinds(events):
    return [(e["ev"], e.get("name")) if e["ev"] == "span" else (e["ev"],)
            for e in events]


@pytest.mark.parametrize("case,method,engine_name,fuse,loops,scbf", [
    ("scbf-batched", "scbf", "batched", 1, 2, {}),
    ("scbf-sequential", "scbf", "sequential", 1, 2, {}),
    ("scbf-fused", "scbf", "batched", 2, 4, {}),
    ("fedavg-batched", "fedavg", "batched", 1, 2, {}),
    ("fedavg-fused", "fedavg", "batched", 2, 2, {}),
    ("scbfwp-mask-fused", "scbf", "batched", 2, 4, PRUNE),
    ("scbfwp-mask-batched", "scbf", "batched", 1, 3, PRUNE),
])
def test_recorded_run_matches_the_reference(tmp_path, case, method,
                                            engine_name, fuse, loops, scbf):
    """Both packages under ``recording`` on the same cohort, the port fed
    the reference's initial weights and permutations: the same sequence
    of event kinds (spans by name), the golden schema's required fields,
    per round ``selected``, ``codec_bytes`` and ``sparse_bytes`` exact and
    ``train_loss`` to 1e-5, the same ``host_offloads``."""
    lr = 0.05 / K if method == "scbf" else 0.05
    ref_c = ref_cohort(num_admissions=600, num_medicines=24, seed=SEED)
    shards = ref_split(ref_c.x_train, ref_c.y_train, K, seed=SEED)
    n_max = max(len(y) for _, y in shards)
    lengths = [n_max] * K if engine_name == "batched" else \
        [len(y) for _, y in shards]
    init, perms, _ = reference_draws(SEED, FEATS, lengths, loops, 1)
    ref_cfg = RefTrainConfig(
        learning_rate=lr, global_loops=loops, local_batch_size=BATCH,
        seed=SEED, scbf=RefScbfConfig(num_clients=K, upload_rate=0.25,
                                      **scbf),
        fed=RefFedConfig(fuse_rounds=fuse, engine=engine_name))
    with ref_trace.recording(str(tmp_path / "ref.jsonl")) as ref_rec:
        want = ref_run(ref_c, ref_cfg, method=method, mlp_features=FEATS)
    with trace.recording(str(tmp_path / "port.jsonl")) as rec:
        got = run_federated(
            generate_cohort(num_admissions=600, num_medicines=24,
                            seed=SEED),
            _cfg(fuse, loops, engine_name, lr=lr, **scbf), method=method,
            mlp_features=FEATS, device="cpu", init_params=init, perms=perms)
    ref_events = ref_report.read_events(str(tmp_path / "ref.jsonl"))
    events = report.read_events(str(tmp_path / "port.jsonl"))
    assert _kinds(events) == _kinds(ref_events)
    for e in events:
        need = REQUIRED_FIELDS.get(e["ev"], set())
        if e["ev"] == "round":
            # the reference's own engines give no more: a FedAvg round
            # has no selection or codec, a sequential one no selection
            need = need - {"selected", "codec_bytes"} \
                if method == "fedavg" else need
            need = need - {"selected"} if engine_name == "sequential" \
                else need
        assert not need - set(e), f"{e['ev']} misses {need - set(e)}"
    if fuse > 1:
        assert {"fused_chunk", "encode", "eval"} <= \
            {e["name"] for e in events if e["ev"] == "span"} \
            or method == "fedavg"
    rounds = [e for e in events if e["ev"] == "round"]
    ref_rounds = [e for e in ref_events if e["ev"] == "round"]
    for g, w in zip(rounds, ref_rounds):
        assert (g.get("selected"), g.get("codec_bytes"), g["sparse_bytes"],
                g["participants"], g["hidden"]) == \
            (w.get("selected"), w.get("codec_bytes"), w["sparse_bytes"],
             w["participants"], w["hidden"])
        np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                   rtol=0, atol=1e-5)
    for g, w in zip(got.records, want.records):
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=1e-5)
    assert rec.counters["host_offloads"] == \
        ref_rec.counters["host_offloads"] == got.telemetry["host_offloads"]


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

_TIMED = ("round_wall_s", "rounds_per_s", "spans", "emitter", "compiles")


@pytest.fixture(scope="module")
def recorded_log(port_cohort, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obs") / "events.jsonl")
    with trace.recording(path):
        res = run_federated(port_cohort, _cfg(2, 4), mlp_features=FEATS,
                            device="cpu")
    return path, res


def test_summary_is_the_references(recorded_log):
    """``summarize`` of one log is the reference's (the clock's fields and
    the emitter aside; span counts equal), here for a port log."""
    path, res = recorded_log
    events = report.read_events(path)
    got, want = report.summarize(events), ref_report.summarize(events)
    assert {k: v for k, v in got.items() if k not in _TIMED} == \
        {k: v for k, v in want.items() if k not in _TIMED}
    assert {k: v["count"] for k, v in got["spans"].items()} == \
        {k: v["count"] for k, v in want["spans"].items()}
    assert report.per_round_table(events) == \
        ref_report.per_round_table(events)
    assert got["host_offloads"] == res.telemetry["host_offloads"] == 2
    assert got["final_train_loss"] == res.records[-1].train_loss


def test_report_cli_end_to_end(recorded_log, tmp_path, capsys):
    path, res = recorded_log
    json_out = str(tmp_path / "report.json")
    trace_out = str(tmp_path / "trace.json")
    assert report.main([path, "--json-out", json_out,
                        "--trace-out", trace_out]) == 0
    out = capsys.readouterr().out
    assert "loop" in out and "~" in out and "spans:" in out
    summary = json.load(open(json_out))
    assert summary["schema"] == trace.EVENT_SCHEMA
    assert summary["rounds"] == 4
    assert summary["total_sparse_bytes"] == \
        sum(r.sparse_bytes for r in res.records)
    assert summary["wall_is_amortized"] is True
    assert summary["compiles"] == {}
    chrome = json.load(open(trace_out))
    assert any(e["ph"] == "X" for e in chrome["traceEvents"])


def test_report_refuses_schema_mismatch(tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"ev": "meta", "ts": 0.0, "schema": 99,
                               "emitter": "repro.obs/99"}) + "\n")
    with pytest.raises(ValueError, match="schema 99"):
        report.read_events(str(bad))
    assert report.main([str(bad)]) == 1
    assert "schema" in capsys.readouterr().err


def test_report_refuses_non_event_file(tmp_path):
    f = tmp_path / "x.jsonl"
    f.write_text('{"ev": "round"}\n')
    with pytest.raises(ValueError, match="meta"):
        report.read_events(str(f))
    g = tmp_path / "y.jsonl"
    g.write_text("not json\n")
    with pytest.raises(ValueError, match="not JSONL"):
        report.read_events(str(g))
