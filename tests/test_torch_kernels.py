"""The port's kernel modules on the CPU: their plain versions against the
reference's Pallas kernels (interpret mode, through ``repro.kernels.ops``)
and oracles (``repro.kernels.ref``),
and the wrappers' device dispatch.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import apoz as az
from repro_torch.kernels import channel_norm as cn
from repro_torch.kernels import select_mask as sm

# the reference's kernel sweep (tests/test_kernels.py)
SHAPES = [(8, 8), (256, 256), (100, 300), (512, 64), (7, 9), (1024, 128),
          (33, 257)]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(shape, dtype, seed):
    """The same matrix for both packages (numpy fp32, then each rounds it
    to the working dtype with round-to-nearest-even)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_channel_norms_plain_matches_pallas(shape, dtype):
    gj, gt = _pair(shape, dtype, 0)
    want_row, want_col = ops.channel_norms(gj)
    row, col = cn.channel_norms_plain(gt)
    assert row.dtype == col.dtype == torch.float32
    # fp32 sums in another order: equal to rounding, not bitwise
    np.testing.assert_allclose(row.numpy(), np.asarray(want_row),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(col.numpy(), np.asarray(want_col),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("q", [0.1, 0.5, 0.9])
def test_select_mask_plain_matches_pallas_bitwise(shape, dtype, q):
    gj, gt = _pair(shape, dtype, 1)
    row, col = cn.channel_norms_plain(gt)
    thr = np.float32(np.quantile((row[:, None] + col[None, :]).numpy(), q))
    want, want_cnt = ops.scbf_select_fused(gj, jnp.asarray(row.numpy()),
                                           jnp.asarray(col.numpy()), thr)
    out, mask, cnt = sm.select_mask_plain(gt, row, col,
                                          torch.tensor(thr),
                                          torch.tensor(0.0))
    assert out.dtype == gt.dtype and mask.dtype == torch.bool
    assert np.array_equal(out.float().numpy().view(np.uint32),
                          np.asarray(want, np.float32).view(np.uint32))
    assert int(cnt) == int(want_cnt) == int(mask.sum())


def test_select_mask_rest_is_added_after_the_pair():
    """(row + col) + rest, never row + (col + rest) nor rest folded into
    thr: a tie that only the reference's order lets pass."""
    row = torch.tensor([1.0], dtype=torch.float32)
    col = torch.tensor([2.0 ** -24], dtype=torch.float32)
    rest = torch.tensor(2.0 ** -24)
    # (1 + 2^-24) + 2^-24 rounds to 1 (ties to even) twice; 1 + 2^-23 > 1
    _, mask, _ = sm.select_mask(torch.ones(1, 1), row, col,
                                torch.tensor(1.0), rest)
    assert not bool(mask[0, 0])
    assert float(col + rest) == 2.0 ** -23 and float(row + 2.0 ** -23) > 1.0


def test_select_mask_minus_inf_scores_never_pass():
    g = torch.ones(3, 2)
    row = torch.tensor([0.0, float("-inf"), 5.0])
    col = torch.tensor([float("-inf"), 1.0])
    out, mask, cnt = sm.select_mask(g, row, col, -1e30, 0.0)
    assert mask.tolist() == [[False, True], [False, False], [False, True]]
    assert int(cnt) == 2 and out.sum().item() == 2.0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("q", [0.1, 0.5, 0.9])
def test_select_compact_plain_matches_pallas_bitwise(shape, dtype, q):
    """rest = 0, drop_zeros off: the TPU kernel's function, bitwise
    (idx, vals, count) against ``ops.select_compact`` (interpret mode)
    and ``ref.select_compact_ref``."""
    gj, gt = _pair(shape, dtype, 7)
    row, col = cn.channel_norms_plain(gt)
    thr = np.float32(np.quantile((row[:, None] + col[None, :]).numpy(), q))
    rj, cj = jnp.asarray(row.numpy()), jnp.asarray(col.numpy())
    idx, vals, cnt = sm.select_compact_plain(
        gt, row, col, torch.tensor(thr), torch.tensor(0.0),
        capacity=gt.numel())
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    for want in (ops.select_compact(gj, rj, cj, thr),
                 ref.select_compact_ref(gj, rj, cj, thr)):
        assert int(cnt) == int(want[2])
        assert np.array_equal(idx.numpy(), np.asarray(want[0]))
        assert vals.numpy().tobytes() == \
            np.asarray(want[1], np.float32).tobytes()


def test_select_compact_capacity_truncates_in_order():
    gj, gt = _pair((32, 16), "fp32", 8)
    row, col = cn.channel_norms_plain(gt)
    thr = np.float32(np.quantile((row[:, None] + col[None, :]).numpy(), 0.5))
    full = sm.select_compact(gt, row, col, float(thr))
    cap = int(full[2]) // 2
    idx, vals, cnt = sm.select_compact(gt, row, col, float(thr),
                                       capacity=cap)
    want = ops.select_compact(gj, jnp.asarray(row.numpy()),
                              jnp.asarray(col.numpy()), thr, capacity=cap)
    assert int(cnt) == int(full[2]) == int(want[2])     # the true count
    assert torch.equal(idx, full[0][:cap]) and torch.equal(vals, full[1][:cap])
    assert np.array_equal(idx.numpy(), np.asarray(want[0]))
    assert vals.numpy().tobytes() == np.asarray(want[1]).tobytes()
    # a capacity above the count: the tail is idx -1 / val 0
    idx, vals, cnt = sm.select_compact(gt, row, col, float(thr),
                                       capacity=gt.numel() + 5)
    k = int(cnt)
    assert (idx[k:] == -1).all() and (vals[k:] == 0).all()


def test_select_compact_drop_zeros_and_rest():
    """drop_zeros keeps kept-and-nonzero entries — np.flatnonzero of the
    select-mask output — and rest is added after the pair sum, as in
    select_mask."""
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (40, 24)).astype(np.float32))
    g[::3] = 0.0
    g[1, 5] = -0.0
    row, col = cn.channel_norms_plain(g + 1.0)
    col[::4] = float("-inf")
    thr = torch.quantile(row[:, None] + col[None, :].clamp(min=0), 0.5)
    for rest in (0.0, 0.37):
        out, mask, cnt = sm.select_mask(g, row, col, thr, rest)
        idx, vals, kept = sm.select_compact(g, row, col, thr, rest,
                                            drop_zeros=True)
        nz = np.flatnonzero(out.numpy())
        assert int(kept) == nz.size < int(cnt)
        assert np.array_equal(idx[:nz.size].numpy(), nz)
        assert vals[:nz.size].numpy().tobytes() == \
            out.numpy().reshape(-1)[nz].tobytes()
        idx2, _, kept2 = sm.select_compact(g, row, col, thr, rest)
        assert int(kept2) == int(cnt)
        assert np.array_equal(idx2[:int(cnt)].numpy(),
                              np.flatnonzero(mask.numpy()))


def test_select_compact_refuses_int32_overflow_and_negative_capacity():
    g = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="capacity"):
        sm.select_compact(g, torch.zeros(4), torch.zeros(5), 0.0,
                          capacity=-1)
    big = torch.empty(2 ** 16, 2 ** 15, device="meta")    # no storage
    with pytest.raises(ValueError, match="2\\^31"):
        sm.select_compact(big, torch.zeros(2 ** 16, device="meta"),
                          torch.zeros(2 ** 15, device="meta"), 0.0)


# the reference's apoz sweep (tests/test_kernels.py) and the SCBFwP path's
# shapes
APOZ_SHAPES = [(16, 8), (512, 256), (1000, 77), (2048, 64), (37, 130),
               (33, 257), (7, 9), (1028, 256)]


@pytest.mark.parametrize("shape", APOZ_SHAPES)
def test_apoz_counts_plain_matches_pallas_bitwise(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    a = np.maximum(x, 0.0)
    a[0, :] = -0.0                       # -0.0 counts as a zero
    a[1, ::2] = np.nan                   # NaN does not
    a[:, shape[1] // 2] = 0.0            # an all-zero column
    got = az.apoz_counts_plain(torch.from_numpy(a))
    assert got.dtype == torch.int32
    for want in (ops.apoz_counts(jnp.asarray(a)),
                 ref.apoz_counts_ref(jnp.asarray(a))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got[shape[1] // 2]) == shape[0]


def test_cpu_tensors_take_the_plain_version_without_launching():
    cn.reset_launches()
    sm.reset_launches()
    az.reset_launches()
    g = torch.randn(33, 257, generator=torch.Generator().manual_seed(0))
    row, col = cn.channel_norms(g)
    prow, pcol = cn.channel_norms_plain(g)
    assert torch.equal(row, prow) and torch.equal(col, pcol)
    out, mask, cnt = sm.select_mask(g, row, col, 300.0, 0.5)
    pout, pmask, pcnt = sm.select_mask_plain(g, row, col,
                                             torch.tensor(300.0),
                                             torch.tensor(0.5))
    assert torch.equal(out, pout) and torch.equal(mask, pmask)
    assert int(cnt) == int(pcnt)
    got = sm.select_compact(g, row, col, 300.0, 0.5, drop_zeros=True)
    want = sm.select_compact_plain(g, row, col, torch.tensor(300.0),
                                   torch.tensor(0.5), g.numel(), True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    acts = torch.relu(g)
    assert torch.equal(az.apoz_counts(acts), az.apoz_counts_plain(acts))
    table = [(g, row, col, 300.0, 0.5), (g[:7, :9].contiguous(),
                                         row[:7], col[:9], 0.0, 0.0)]
    sm.select_mask_leaves(table)
    cc = sm.compact_count(table, drop_zeros=True)
    sm.compact_scatter(cc, [4, 0])
    norms = cn.channel_norms_leaves([leaf[0] for leaf in table])
    assert all(torch.equal(a, b) for got, leaf in zip(norms, table)
               for a, b in zip(got, cn.channel_norms_plain(leaf[0])))
    counts, frac = az.apoz_counts_leaves([acts, torch.relu(table[1][0])],
                                         0.25)
    assert torch.equal(counts[0], az.apoz_counts_plain(acts))
    assert frac.shape == (g.shape[1] + 9,)
    assert cn.launches == 0 and sm.mask_launches == 0 and az.launches == 0
    assert sm.compact_count_launches == 0
    assert sm.compact_scatter_launches == 0


@pytest.mark.parametrize("bad", ["float64", "rank1", "noncontig", "empty"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    g = {"float64": torch.zeros(4, 4, dtype=torch.float64),
         "rank1": torch.zeros(16),
         "noncontig": torch.zeros(4, 6)[:, ::2],
         "empty": torch.zeros(0, 4)}[bad]
    with pytest.raises((TypeError, ValueError)):
        cn.channel_norms(g)
    row = torch.zeros(g.shape[0] if g.ndim else 1)
    col = torch.zeros(g.shape[-1])
    with pytest.raises((TypeError, ValueError)):
        sm.select_mask(g, row, col, 0.0)
    with pytest.raises((TypeError, ValueError)):
        sm.select_compact(g, row, col, 0.0)
    with pytest.raises((TypeError, ValueError)):
        az.apoz_counts(g)
    cn.reset_launches()


def test_select_mask_checks_score_shapes():
    with pytest.raises(ValueError, match="col"):
        sm.select_mask(torch.zeros(4, 5), torch.zeros(4), torch.zeros(4),
                       0.0)
    with pytest.raises(ValueError, match="scalar"):
        sm.select_mask(torch.zeros(4, 5), torch.zeros(4), torch.zeros(5),
                       torch.zeros(2))


# a client pass as a leaf table: W0 scaled down, the ragged check shapes
# and a one-column last layer
TABLE_SHAPES = [(183, 16), (33, 257), (7, 9), (64, 1)]


def _table(dtype, rest, seed, tie=False):
    """Leaves of mixed shapes with -inf scores on some rows and columns
    and kept-but-zero rows of g; each leaf's threshold is a quantile of
    its finite pair sums, or (``tie``) exactly one of them."""
    rng = np.random.default_rng(seed)
    leaves, jax_leaves = [], []
    for k, shape in enumerate(TABLE_SHAPES):
        gj, gt = _pair(shape, dtype, seed + k)
        gt[::5] = 0
        gj = jnp.asarray(gt.float().numpy()).astype(DTYPES[dtype][0])
        row = torch.from_numpy(rng.random(shape[0]).astype(np.float32))
        col = torch.from_numpy(rng.random(shape[1]).astype(np.float32))
        row[::7] = float("-inf")
        if shape[1] > 1:
            col[1::5] = float("-inf")
        pairs = (row[:, None] + col[None, :]).reshape(-1)
        finite = torch.sort(pairs[torch.isfinite(pairs)]).values
        thr = finite[finite.numel() // 2].clone() if tie else \
            torch.tensor(np.float32(np.quantile(finite.numpy(), 0.4)))
        leaves.append((gt, row, col, thr, torch.tensor(rest)))
        jax_leaves.append((gj, jnp.asarray(row.numpy()),
                           jnp.asarray(col.numpy()), np.float32(thr)))
    return leaves, jax_leaves


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rest", [0.0, 0.37])
@pytest.mark.parametrize("tie", [False, True])
def test_select_mask_leaves_cpu_route_matches_plain_and_pallas(dtype, rest,
                                                               tie):
    """The table wrapper's CPU route is the single-leaf plain version leaf
    by leaf, and with rest = 0 the Pallas kernel's (interpret mode)."""
    leaves, jax_leaves = _table(dtype, rest, 30, tie)
    outs, masks, counts = sm.select_mask_leaves(leaves)
    assert counts.dtype == torch.int32 and counts.shape == (len(leaves),)
    for leaf, jleaf, out, mask, cnt in zip(leaves, jax_leaves, outs, masks,
                                           counts):
        pout, pmask, pcnt = sm.select_mask_plain(*leaf)
        assert torch.equal(out, pout) and torch.equal(mask, pmask)
        assert int(cnt) == int(pcnt)
        if rest == 0.0:
            want, want_cnt = ops.scbf_select_fused(*jleaf)
            assert np.array_equal(out.float().numpy().view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))
            assert int(cnt) == int(want_cnt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rest", [0.0, 0.37])
@pytest.mark.parametrize("drop_zeros", [False, True])
def test_compact_leaves_cpu_route_matches_plain_and_pallas(dtype, rest,
                                                           drop_zeros):
    """compact_count + compact_scatter over a table (capacities at size,
    half the count and the count; all leaves and a subset) are the
    single-leaf plain version leaf by leaf, and with rest = 0 and
    drop_zeros off the Pallas kernel's (interpret mode)."""
    leaves, jax_leaves = _table(dtype, rest, 40, tie=rest > 0)
    cc = sm.compact_count(leaves, drop_zeros=drop_zeros)
    full = [sm.select_compact_plain(*leaf, leaf[0].numel(), drop_zeros)
            for leaf in leaves]
    nnz = [int(c) for _, _, c in full]
    assert cc.counts.tolist() == nnz
    for which, caps in ((None, [leaf[0].numel() for leaf in leaves]),
                        (None, [c // 2 for c in nnz]), (None, nnz),
                        ([1, 3], [nnz[1], nnz[3]])):
        buf, views = sm.compact_scatter(cc, caps, which)
        for k, cap, (idx, vals) in zip(which or range(len(leaves)), caps,
                                       views):
            assert idx.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr()
            want = sm.select_compact_plain(*leaves[k], cap, drop_zeros)
            assert torch.equal(idx, want[0]) and torch.equal(vals, want[1])
            if rest == 0.0 and not drop_zeros:
                jwant = ops.select_compact(*jax_leaves[k], capacity=cap)
                assert np.array_equal(idx.numpy(), np.asarray(jwant[0]))
                assert vals.numpy().tobytes() == \
                    np.asarray(jwant[1], np.float32).tobytes()


def test_select_mask_refuses_int32_overflow():
    big = torch.empty(2 ** 16, 2 ** 15, device="meta")    # no storage
    with pytest.raises(ValueError, match="2\\^31"):
        sm.select_mask(big, torch.zeros(2 ** 16, device="meta"),
                       torch.zeros(2 ** 15, device="meta"), 0.0)
    with pytest.raises(ValueError, match="2\\^31"):
        sm.select_mask_leaves([(torch.zeros(2, 2), torch.zeros(2),
                                torch.zeros(2), 0.0, 0.0),
                               (big, torch.zeros(2 ** 16, device="meta"),
                                torch.zeros(2 ** 15, device="meta"), 0.0,
                                0.0)])


def test_leaf_tables_refuse_what_a_launch_does_not_take():
    leaf = (torch.zeros(4, 5), torch.zeros(4), torch.zeros(5), 0.0, 0.0)
    for bad in ([], [leaf] * (sm.MAX_LEAVES + 1)):
        with pytest.raises(ValueError, match="leaves"):
            sm.select_mask_leaves(bad)
        with pytest.raises(ValueError, match="leaves"):
            sm.compact_count(bad)
    cc = sm.compact_count([leaf, leaf])
    with pytest.raises(ValueError, match="capacity"):
        sm.compact_scatter(cc, [3])
    with pytest.raises(ValueError, match="capacity"):
        sm.compact_scatter(cc, [3, -1])
    with pytest.raises(ValueError, match="scalar"):
        sm.select_mask_leaves([leaf[:3] + (torch.zeros(2), 0.0)])


# a client pass of the main path, then the ragged check shapes
NORM_TABLE = [(2917, 256), (256, 64), (64, 1), (33, 257), (7, 9), (1024, 128)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_channel_norms_leaves_cpu_route_matches_plain_and_pallas(dtype):
    """The table wrapper's CPU route is the plain version leaf by leaf,
    and within fp32 rounding of the Pallas kernel (interpret mode)."""
    pairs = [_pair(shape, dtype, 50 + k) for k, shape in
             enumerate(NORM_TABLE)]
    got = cn.channel_norms_leaves([gt for _, gt in pairs])
    assert len(got) == len(NORM_TABLE)
    for (gj, gt), (row, col) in zip(pairs, got):
        prow, pcol = cn.channel_norms_plain(gt)
        assert torch.equal(row, prow) and torch.equal(col, pcol)
        assert row.dtype == col.dtype == torch.float32
        want_row, want_col = ops.channel_norms(gj)
        np.testing.assert_allclose(row.numpy(), np.asarray(want_row),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(col.numpy(), np.asarray(want_col),
                                   rtol=1e-5, atol=1e-6)


def _acts(shape, seed):
    """ReLU activations with -0.0 (a zero), NaN (not one) and an all-zero
    column."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    a = np.maximum(x, 0.0)
    a[0, :] = -0.0
    a[1, ::2] = np.nan
    a[:, shape[1] // 2] = 0.0
    return a


@pytest.mark.parametrize("shapes", [[(512, 256), (512, 64)],
                                    [(33, 257), (7, 9), (1000, 77)]],
                         ids=["batch", "ragged"])
@pytest.mark.parametrize("with_recip", [True, False])
def test_apoz_counts_leaves_cpu_route_matches_plain_and_pallas(shapes,
                                                               with_recip):
    """Counts bitwise the plain version, ``ops.apoz_counts`` (interpret
    mode) and ``ref.apoz_counts_ref``; the fractions, leaf after leaf in
    one vector, bitwise count · fl(1/B)."""
    arrays = [_acts(shape, 60 + k) for k, shape in enumerate(shapes)]
    recip = np.float32(1.0) / np.float32(shapes[0][0])
    counts, frac = az.apoz_counts_leaves(
        [torch.from_numpy(a) for a in arrays],
        float(recip) if with_recip else None)
    assert len(counts) == len(shapes)
    for a, got in zip(arrays, counts):
        assert got.dtype == torch.int32
        assert torch.equal(got, az.apoz_counts_plain(torch.from_numpy(a)))
        for want in (ops.apoz_counts(jnp.asarray(a)),
                     ref.apoz_counts_ref(jnp.asarray(a))):
            assert np.array_equal(got.numpy(), np.asarray(want))
        assert int(got[a.shape[1] // 2]) == a.shape[0]
    if not with_recip:
        assert frac is None
        return
    want = np.concatenate([c.numpy() for c in counts]).astype(np.float32) \
        * recip
    assert frac.dtype == torch.float32
    assert frac.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("bad", ["empty", "too_many", "mixed_devices",
                                 "mixed_dtypes", "noncontig", "wrong_dtype"])
def test_table_wrappers_refuse_what_a_launch_does_not_take(bad):
    """channel_norms_leaves and apoz_counts_leaves refuse an empty table,
    more than MAX_LEAVES leaves, leaves on two devices or (channel norms)
    of two dtypes, a non-contiguous leaf and a dtype the kernel does not
    take."""
    a = torch.zeros(4, 6)
    tables = {
        "empty": ([], []),
        "too_many": ([a] * (cn.MAX_LEAVES + 1), [a] * (az.MAX_LEAVES + 1)),
        "mixed_devices": ([a, torch.zeros(4, 6, device="meta")],
                          [a, torch.zeros(4, 6, device="meta")]),
        "mixed_dtypes": ([a, a.to(torch.bfloat16)],
                         [a, a.to(torch.bfloat16)]),
        "noncontig": ([a, a[:, ::2]], [a, a[:, ::2]]),
        "wrong_dtype": ([a.double()], [a.to(torch.bfloat16)]),
    }
    norms, acts = tables[bad]
    with pytest.raises((TypeError, ValueError)):
        cn.channel_norms_leaves(norms)
    with pytest.raises((TypeError, ValueError)):
        az.apoz_counts_leaves(acts, 0.25)
    assert cn.launches == 0 and az.launches == 0


def test_channel_norms_refuses_a_table_beyond_its_scratch(monkeypatch):
    """The launch's partials and tickets live in a workspace the wrapper
    owns: a table beyond the fixed scratch the library once held (2^22
    floats) is no longer refused; the device's workspace grows to it (a
    new zeroed tensor, at least twice the old size), a smaller table
    reuses it, and an outgrown one is not kept by the wrapper."""
    one = cn.workspace_words([torch.empty(2917, 256, device="meta")])
    assert one == 31 * 256 + 4 + 4 * 2917 + 31       # partials + tickets
    big = [torch.empty(2 ** 14, 2 ** 14, device="meta")]
    assert cn.workspace_words(big) > 1 << 22
    assert cn.workspace_words([torch.empty(64, 1, device="meta")]) == 0
    dev = torch.device("meta")
    monkeypatch.setattr(cn, "_workspaces", {})
    ws = cn._workspace(dev, one)
    assert ws.numel() == one and ws.dtype == torch.int32
    assert cn._workspace(dev, 10) is ws and cn.workspace(dev) is ws
    grown = cn._workspace(dev, cn.workspace_words(big))
    assert grown is not ws and grown.numel() == cn.workspace_words(big)
    assert cn.workspace(dev) is grown
    doubled = cn._workspace(dev, grown.numel() + 1)
    assert doubled.numel() == 2 * grown.numel()
    assert cn._workspace(dev, grown.numel() + 1) is doubled
