"""The port's kernel modules on the CPU: their plain versions against the
reference's Pallas kernels (interpret mode, through ``repro.kernels.ops``),
and the wrappers' device dispatch.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
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


def test_cpu_tensors_take_the_plain_version_without_launching():
    cn.reset_launches()
    sm.reset_launches()
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
    assert cn.launches == 0 and sm.launches == 0


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
    cn.reset_launches()


def test_select_mask_checks_score_shapes():
    with pytest.raises(ValueError, match="col"):
        sm.select_mask(torch.zeros(4, 5), torch.zeros(4), torch.zeros(4),
                       0.0)
    with pytest.raises(ValueError, match="scalar"):
        sm.select_mask(torch.zeros(4, 5), torch.zeros(4), torch.zeros(5),
                       torch.zeros(2))
