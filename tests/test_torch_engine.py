"""The batched cohort engine of the port against the reference on the
CPU: the padded cohort and its buckets exactly, the slot-stacked trainer
against ``jax.vmap`` of the reference's bodies to 1e-5, the slot forms of
the kernels' plain versions and of the selection bitwise against their
one-client calls, and a whole ``BatchedEngine.scbf_round`` (IID and
Dirichlet shards under sampling, with and without DP) against the
reference's: payload bytes and upload fractions exactly, decoded values
to 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as ref_wire
from repro.config import ScbfConfig as RefScbfConfig
from repro.core import client as ref_client
from repro.data.medical import dirichlet_split as ref_dirichlet
from repro.data.medical import federated_split as ref_split
from repro.data.medical import generate_cohort as ref_cohort
from repro.fed import cohort as ref_cohort_mod
from repro.fed import engine as ref_engine
from repro.models.mlp_net import init_mlp
from repro_torch import config as tcfg
from repro_torch.comm import wire
from repro_torch.core import channels, selection
from repro_torch.core.client import local_train_slots
from repro_torch.fed import cohort, engine
from repro_torch.kernels import channel_norm as cn
from repro_torch.kernels import select_mask as sm
from repro_torch.params import from_numpy

from _torch_parity import epoch_perms, np_tree, reference_normals

FEATS = (40, 16, 8, 1)


@pytest.mark.parametrize("policy", ["pow2", "exact"])
@pytest.mark.parametrize("k", [1, 3, 5, 8, 13])
@pytest.mark.parametrize("multiple", [1, 2, 4])
def test_bucket_size_matches_reference(policy, k, multiple):
    for p in range(0, k + 1):
        assert cohort.bucket_size(p, k, policy, multiple) == \
            ref_cohort_mod.bucket_size(p, k, policy, multiple)


def test_bucket_size_refusals_match_reference():
    for args in ((6, 5, "pow2"), (1, 5, "fibonacci")):
        with pytest.raises(ValueError):
            ref_cohort_mod.bucket_size(*args)
        with pytest.raises(ValueError):
            cohort.bucket_size(*args)


@pytest.mark.parametrize("sizes", [(7, 7, 7), (9, 3, 12, 1)])
def test_pad_clients_matches_reference(sizes):
    rng = np.random.default_rng(0)
    clients = [(rng.random((n, 5)).astype(np.float32),
                (rng.random(n) < 0.5).astype(np.float32)) for n in sizes]
    got, want = cohort.pad_clients(clients), ref_cohort_mod.pad_clients(
        clients)
    for name in ("x", "y", "w"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.counts, want.counts)
    assert (got.n_max, got.num_clients, got.uniform) == \
        (want.n_max, want.num_clients, want.uniform)
    for bad in ([], [(np.zeros((0, 5), np.float32), np.zeros(0))]):
        with pytest.raises(ValueError):
            cohort.pad_clients(bad)


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "masked"])
@pytest.mark.parametrize("epochs,batch", [(1, 32), (2, 50)])
def test_slot_trainer_matches_vmapped_reference(masked, epochs, batch):
    """``local_train_slots`` on S slots == ``jax.vmap`` of the reference's
    ``local_train_impl`` (uniform) or ``masked_local_train_impl`` (ragged
    shards, padded) over the same slots, to 1e-5."""
    rng = np.random.default_rng(1)
    sizes = (130, 97, 130, 41) if masked else (130, 130, 130)
    clients = [((rng.random((n, FEATS[0])) < 0.2).astype(np.float32),
                (rng.random(n) < 0.4).astype(np.float32)) for n in sizes]
    padded = ref_cohort_mod.pad_clients(clients)
    p0 = np_tree(init_mlp(FEATS, jax.random.PRNGKey(2)))
    keys = jax.random.split(jax.random.PRNGKey(5), len(sizes))
    if masked:
        want = jax.vmap(lambda x, y, w, k: ref_client.masked_local_train_impl(
            p0, x, y, w, 0.05, k, batch_size=batch, epochs=epochs))(
            padded.x, padded.y, padded.w, keys)
    else:
        want = jax.vmap(lambda x, y, k: ref_client.local_train_impl(
            p0, x, y, 0.05, k, batch_size=batch, epochs=epochs))(
            padded.x, padded.y, keys)
    perms = np.stack([np.stack(epoch_perms(k, padded.n_max, epochs))
                      for k in keys])
    s = len(sizes)
    start = tuple({k: v.unsqueeze(0).expand(s, *v.shape)
                   for k, v in layer.items()} for layer in from_numpy(p0,
                                                                      "cpu"))
    port = cohort.pad_clients(clients)
    got = local_train_slots(start, port.x, port.y, 0.05, perms,
                            w=port.w if masked else None, batch_size=batch,
                            epochs=epochs)
    for lg, lw in zip(np_tree(got), np_tree(want)):
        for k in lw:
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="perms"):
        local_train_slots(start, port.x, port.y, 0.05, perms[:, :, :-1],
                          batch_size=batch, epochs=epochs)


def _slot_delta(s_count, feats=FEATS, seed=3):
    rng = np.random.default_rng(seed)
    return tuple({"w": torch.from_numpy(rng.standard_normal(
                      (s_count, a, b)).astype(np.float32) * 0.1),
                  "b": torch.from_numpy(rng.standard_normal(
                      (s_count, b)).astype(np.float32) * 0.1)}
                 for a, b in zip(feats[:-1], feats[1:]))


def _slot_of(tree, s):
    return tuple({k: None if v is None else v[s] for k, v in layer.items()}
                 for layer in tree)


@pytest.mark.parametrize("s_count", [1, 3, 5])
def test_slot_plain_forms_are_per_slot_calls_bitwise(s_count):
    """The plain slot forms of K1, K2 and K3 (a loop over slots of the
    one-matrix plain versions, behind the same wrappers) give slot s
    bitwise what a one-slot call gives, shared (slot stride 0) and
    stacked operands alike."""
    g = _slot_delta(s_count)[0]["w"]
    (row, col), = cn.channel_norms_leaves([g])
    for s in range(s_count):
        r1, c1 = cn.channel_norms(g[s])
        assert torch.equal(row[s], r1) and torch.equal(col[s], c1)
    thr = torch.stack([channels.quantile(
        (row[s][:, None] + col[s][None, :]).reshape(-1), 0.8)
        for s in range(s_count)])
    rest = torch.linspace(0.0, 0.3, s_count)
    shared = torch.zeros(g.shape[1])
    for r in (row, shared):
        leaf = (g, r, col, thr, rest)
        outs, masks, counts = sm.select_mask_leaves([leaf])
        cc = sm.compact_count([leaf], drop_zeros=True)
        nnz = cc.counts.tolist()
        _, views = sm.compact_scatter(cc, nnz)
        for s in range(s_count):
            one = sm.leaf_slot(leaf, s)
            o1, m1, c1 = sm.select_mask(*one)
            assert torch.equal(outs[0][s], o1) and torch.equal(masks[0][s],
                                                               m1)
            assert int(counts[s]) == int(c1)
            i1, v1, k1 = sm.select_compact(*one, capacity=nnz[s],
                                           drop_zeros=True)
            assert cc.pairs[s] == (0, s) and nnz[s] == int(k1)
            assert torch.equal(views[s][0], i1) and torch.equal(views[s][1],
                                                                v1)


def test_slot_wrappers_refuse_past_their_limits():
    """K2 and K3's count take at most MAX_SLOTS (leaf, slot) pairs a
    launch and refuse more with ValueError (their callers split a bigger
    round into groups); the scatter has no limit of its own, and K1 has
    none either: 300 slots at the paper's widths need more than the 2^22
    words of partials the library once held, and size its workspace."""
    assert cn.workspace_words(
        [torch.empty(300, 2917, 256, device="meta")]) > 1 << 22
    leaf = (torch.zeros(sm.MAX_SLOTS + 1, 2, 2), torch.zeros(2),
            torch.zeros(2), 0.0, 0.0)
    with pytest.raises(ValueError, match="MAX_SLOTS"):
        sm.select_mask_leaves([leaf])
    with pytest.raises(ValueError, match="MAX_SLOTS"):
        sm.compact_count([leaf])
    # the scatter takes every pair of a count pass, however many
    leaf = (torch.arange(1, 4 * 300 + 1, dtype=torch.float32)
            .reshape(300, 2, 2), torch.zeros(2), torch.zeros(2), -1.0, 0.0)
    cc = sm.compact_count([leaf])
    _, views = sm.compact_scatter(cc, [4] * len(cc.pairs))
    assert len(views) == 300
    for s, (idx, vals) in enumerate(views):
        assert idx.tolist() == [0, 1, 2, 3]
        assert vals.tolist() == [4 * s + 1.0, 4 * s + 2, 4 * s + 3, 4 * s + 4]
    with pytest.raises(ValueError, match="scalar"):
        sm.select_mask_leaves([(torch.zeros(3, 2, 2), torch.zeros(2),
                                torch.zeros(2), torch.zeros(2), 0.0)])


@pytest.mark.parametrize("score_norm", [False, True])
@pytest.mark.parametrize("pruned", [False, True])
def test_slot_selection_is_per_slot_selection(score_norm, pruned):
    """``select_gradients`` on a slot-stacked delta: slot s's masked
    delta, masks, threshold and edge operands are bitwise the one-client
    pipeline's on slot s; ``UploadStats.from_slot_masks`` is
    ``from_masks`` a slot; ``wire.encode_round`` is ``encode`` a slot,
    byte for byte."""
    s_count = 4
    g = _slot_delta(s_count, seed=7)
    g[0]["w"][1, :, 3] = 0.0                  # a dead column in slot 1
    nmasks = None
    if pruned:
        nmasks = [torch.ones(16), torch.ones(8)]
        nmasks[0][[2, 9]] = 0.0
        nmasks[1][5] = 0.0
    masked, masks, thr, ops = selection.select_gradients(
        g, 0.2, score_norm=score_norm, neuron_masks=nmasks)
    stats = selection.UploadStats.from_slot_masks(masks, s_count - 1)
    payloads = wire.encode_round(masked, ops, s_count - 1)
    assert len(stats) == len(payloads) == s_count - 1
    for s in range(s_count):
        m1, k1, t1, o1 = selection.select_gradients(
            _slot_of(g, s), 0.2, score_norm=score_norm, neuron_masks=nmasks)
        assert torch.equal(thr[s], t1)
        for a, b in zip(_slot_of(masked, s), m1):
            assert all(torch.equal(a[k], b[k]) for k in b)
        for a, b in zip(_slot_of(masks, s), k1):
            assert all(torch.equal(a[k], b[k]) for k in b if b[k] is not None)
        for op, op1 in zip(ops, o1):
            assert torch.equal(op.col[s], op1.col)
            assert torch.equal(op.rest[s], op1.rest)
        if s == s_count - 1:
            continue                          # past num: not emitted
        assert stats[s] == selection.UploadStats.from_masks(k1)
        want = wire.encode(m1)
        assert payloads[s].keys == want.keys
        for a, b in zip(payloads[s].layers, want.layers):
            assert (a.codec, a.shape, a.nnz, a.nbytes) == \
                (b.codec, b.shape, b.nnz, b.nbytes)
            np.testing.assert_array_equal(a.values, b.values)
            for f in ("idx", "bitmap"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)


def _shards(partition):
    c = ref_cohort(num_admissions=1200, num_medicines=40, seed=0)
    if partition == "iid":
        return ref_split(c.x_train, c.y_train, 5, seed=0)
    return ref_dirichlet(c.x_train, c.y_train, 5, alpha=0.5, seed=0)


def _payloads_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.nbytes == w.nbytes
        assert [lp.codec for lp in g.layers] == \
            [lp.codec for lp in w.layers]
        for lg, lw in zip(wire.decode(g), np_tree(ref_wire.decode(w))):
            for k in lw:
                np.testing.assert_allclose(lg[k].numpy(), lw[k], atol=1e-5,
                                           rtol=0)


@pytest.mark.parametrize("dp", [0.0, 0.5], ids=["no-dp", "dp"])
@pytest.mark.parametrize("partition,participants", [
    ("iid", (0, 1, 2, 3, 4)), ("iid", (1, 3, 4)),
    ("dirichlet", (0, 2, 3)), ("dirichlet", (0, 1, 2, 3, 4))])
def test_batched_scbf_round_matches_reference(partition, participants, dp):
    """One batched round of the port against the reference's on the same
    shards, params and draws (epoch permutations of the padded shard
    from the training keys, the DP normals from the DP keys): payload
    bytes, codecs and upload fractions exactly, decoded values to
    1e-5."""
    shards = _shards(partition)
    feats = (40, 16, 8, 1)
    p0 = np_tree(init_mlp(feats, jax.random.PRNGKey(4)))
    cfg_kw = dict(upload_rate=0.15, dp_noise_multiplier=dp)
    ref_eng = ref_engine.BatchedEngine(shards, 64, 2)
    part = np.asarray(participants)
    ckeys = jax.random.split(jax.random.PRNGKey(11), part.size)
    skeys = jax.random.split(jax.random.PRNGKey(12), part.size)
    dkeys = jax.random.split(jax.random.PRNGKey(13), part.size)
    want, wstats = ref_eng.scbf_round(
        jax.tree_util.tree_map(jnp.asarray, p0), part, 0.01, ckeys, skeys,
        dkeys, RefScbfConfig(**cfg_kw))
    eng = engine.BatchedEngine(shards, 64, 2, "cpu")
    assert eng.cohort.uniform == ref_eng.cohort.uniform
    perms = [epoch_perms(k, eng.perm_length(c), 2)
             for k, c in zip(ckeys, part)]
    shapes = [tuple(p0[l][k].shape) for l, k in wire.flat_keys(p0)]
    noise = [reference_normals(k, shapes) for k in dkeys] if dp else None
    got, stats = eng.scbf_round(from_numpy(p0, "cpu"), part, 0.01, perms,
                                tcfg.ScbfConfig(**cfg_kw), noise=noise)
    _payloads_match(got, want)
    assert [s.upload_fraction for s in stats] == \
        [s.upload_fraction for s in wstats]
    assert [s.uploaded_params for s in stats] == \
        [s.uploaded_params for s in wstats]


@pytest.mark.parametrize("dp", [0.0, 0.5], ids=["no-dp", "dp"])
def test_sequential_scbf_round_matches_reference(dp):
    """The sequential engine, DP included, against the reference's."""
    shards = _shards("iid")
    p0 = np_tree(init_mlp((40, 16, 8, 1), jax.random.PRNGKey(4)))
    part = np.array([0, 2, 4])
    keys = [jax.random.split(jax.random.PRNGKey(s), 3) for s in (21, 22, 23)]
    cfg_kw = dict(upload_rate=0.15, dp_noise_multiplier=dp)
    want, wstats = ref_engine.SequentialEngine(shards, 64, 2).scbf_round(
        jax.tree_util.tree_map(jnp.asarray, p0), part, 0.01, *keys,
        RefScbfConfig(**cfg_kw))
    eng = engine.SequentialEngine(shards, 64, 2, "cpu")
    perms = [epoch_perms(k, eng.perm_length(c), 2)
             for k, c in zip(keys[0], part)]
    shapes = [tuple(p0[l][k].shape) for l, k in wire.flat_keys(p0)]
    noise = [reference_normals(k, shapes) for k in keys[2]] if dp else None
    got, stats = eng.scbf_round(from_numpy(p0, "cpu"), part, 0.01, perms,
                                tcfg.ScbfConfig(**cfg_kw), noise=noise)
    _payloads_match(got, want)
    assert [s.upload_fraction for s in stats] == \
        [s.upload_fraction for s in wstats]


def test_batched_fedavg_round_matches_reference():
    shards = _shards("dirichlet")
    p0 = np_tree(init_mlp((40, 16, 8, 1), jax.random.PRNGKey(4)))
    part = np.array([1, 3, 4])
    ckeys = jax.random.split(jax.random.PRNGKey(31), part.size)
    ref_eng = ref_engine.BatchedEngine(shards, 64, 2)
    want, wcounts = ref_eng.fedavg_round(
        jax.tree_util.tree_map(jnp.asarray, p0), part, 0.05, ckeys)
    eng = engine.BatchedEngine(shards, 64, 2, "cpu")
    perms = [epoch_perms(k, eng.perm_length(c), 2)
             for k, c in zip(ckeys, part)]
    got, counts = eng.fedavg_round(from_numpy(p0, "cpu"), part, 0.05, perms)
    np.testing.assert_array_equal(counts, wcounts)
    assert len(got) == len(want) == part.size
    for g, w in zip(got, want):
        for lg, lw in zip(np_tree(g), np_tree(w)):
            for k in lw:
                np.testing.assert_allclose(lg[k], lw[k], atol=1e-5, rtol=0)


def _same_payloads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys == w.keys
        for a, b in zip(g.layers, w.layers):
            assert (a.codec, a.nnz, a.nbytes) == (b.codec, b.nnz, b.nbytes)
            np.testing.assert_array_equal(a.values, b.values)
            for f in ("idx", "bitmap"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dp", [0.0, 0.5], ids=["no-dp", "dp"])
def test_batched_round_past_the_old_slot_caps_runs(monkeypatch, dp):
    """A round of more (leaf, slot) pairs than one K2 or K3 launch takes
    runs, split into groups of slots (MAX_SLOTS cut to 4 here: 6 slots x 3
    weight leaves are 6 groups of one slot).  The split round is bitwise
    the round in one group, and on a slot-stacked delta the split
    selection and encoder give each slot bitwise what one-slot calls give:
    masked delta, masks, payload and upload stats."""
    shards = _shards("iid") + _shards("iid")[:1]      # 6 clients
    p0 = from_numpy(np_tree(init_mlp(FEATS, jax.random.PRNGKey(0))), "cpu")
    eng = engine.BatchedEngine(shards, 64, 1, "cpu", bucket="exact")
    cfg = tcfg.ScbfConfig(upload_rate=0.15, dp_noise_multiplier=dp)
    shapes = [tuple(p0[l][k].shape) for l, k in wire.flat_keys(p0)]
    rng = np.random.default_rng(3)
    part = np.arange(6)
    perms = [[rng.permutation(eng.perm_length(k))] for k in part]
    noise = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in part]
    whole, whole_stats = eng.scbf_round(p0, part, 0.01, perms, cfg,
                                        noise=noise)
    monkeypatch.setattr(sm, "MAX_SLOTS", 4)
    assert channels.slot_groups(6, 3) == [(k, k + 1) for k in range(6)]
    split, split_stats = eng.scbf_round(p0, part, 0.01, perms, cfg,
                                        noise=noise)
    _same_payloads(split, whole)
    assert split_stats == whole_stats
    g = _slot_delta(6, seed=11)
    masked, masks, _, ops = selection.select_gradients(g, 0.2)
    payloads = wire.encode_round(masked, ops, 6)
    stats = selection.UploadStats.from_slot_masks(masks, 6)
    for k in range(6):
        m1, k1, _, o1 = selection.select_gradients(_slot_of(g, k), 0.2)
        for a, b in zip(_slot_of(masked, k), m1):
            assert all(torch.equal(a[n], b[n]) for n in b)
        for a, b in zip(_slot_of(masks, k), k1):
            assert all(torch.equal(a[n], b[n]) for n in b)
        _same_payloads([payloads[k]], [wire.encode(m1)])
        assert stats[k] == selection.UploadStats.from_masks(k1)


def test_empty_round_launches_nothing():
    eng = engine.BatchedEngine(_shards("iid"), 64, 1, "cpu")
    p0 = from_numpy(np_tree(init_mlp((40, 16, 8, 1), jax.random.PRNGKey(0))),
                    "cpu")
    assert eng.scbf_round(p0, [], 0.1, [], tcfg.ScbfConfig()) == ([], [])
    got, counts = eng.fedavg_round(p0, [], 0.1, [])
    assert got == [] and counts.size == 0


def test_make_engine_refusals():
    shards = _shards("iid")
    assert isinstance(engine.make_engine("batched", shards, 64, 1, "cpu"),
                      engine.BatchedEngine)
    with pytest.raises(ValueError, match="engine"):
        engine.make_engine("vectorised", shards, 64, 1, "cpu")
    with pytest.raises(ValueError, match="bucket"):
        engine.make_engine("batched", shards, 64, 1, "cpu", bucket="odd")
    with pytest.raises(NotImplementedError, match="A15"):
        engine.make_engine("batched", shards, 64, 1, "cpu", pods=2)
