"""K3's scatter in the bitmap form (``select_mask.compact_scatter`` with
``forms``): a bitmap pair's packed bitmap is ``np.packbits`` of its
compacted entries' mask and its values are the coo form's, on the CPU
route and — the ``card`` cases, skipped where there is no CUDA card —
bitwise the same from the hand-written kernel.  The file imports no JAX:
the card's cases compare with the plain PyTorch route.  On a machine with
a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_compact_bitmap.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import select_mask as sm

# name: (leaves as (slots, M, N), dtype, drop_zeros, forms a pair — cycled
# over the launch's pairs —, what the entries hold)
CASES = {
    # 60 entries: a size that is not a multiple of 8, on the vector path
    "size_not_multiple_of_8": ([(1, 5, 12)], torch.float32, True,
                               ["bitmap"], "normal"),
    # N % 4 != 0: the scalar path, 777 entries
    "n_mod_4": ([(3, 37, 21)], torch.float32, True, ["bitmap"], "normal"),
    # 6,208 entries: three whole 2,048-entry tiles and a partial fourth
    "tiles": ([(2, 97, 64)], torch.float32, True, ["bitmap"], "normal"),
    # the same on the scalar path
    "tiles_scalar": ([(1, 101, 63)], torch.float32, True, ["bitmap"],
                     "normal"),
    # kept entries that are -0.0 or +0.0 (the wire drops both)
    "signed_zeros": ([(2, 33, 40)], torch.float32, True, ["bitmap"],
                     "signed_zeros"),
    # a pair that keeps nothing: its bitmap is zeros, it has no value
    "all_zero": ([(2, 9, 20)], torch.float32, True, ["bitmap"], "zeros"),
    # one launch of coo and bitmap pairs, slot-stacked, the MLP's shapes
    # at small size
    "mixed": ([(3, 61, 32), (3, 32, 8), (3, 8, 1)], torch.float32, True,
              ["bitmap", "coo"], "normal"),
    # the rule alone (zeros kept) and bf16 leaves
    "rule_only": ([(2, 45, 12)], torch.float32, False, ["bitmap"],
                  "signed_zeros"),
    "bf16": ([(2, 70, 36), (2, 36, 5)], torch.bfloat16, True,
             ["bitmap", "coo", "bitmap"], "normal"),
}


def _leaves(case, device):
    shapes, dtype, _, _, fill = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 60)
    leaves = []
    for slots, m, n in shapes:
        g = rng.standard_normal((slots, m, n)).astype(np.float32)
        if fill == "signed_zeros":
            g[:, ::3] = -0.0
            g[:, 1::5] = 0.0
        elif fill == "zeros":
            g[1] = 0.0
        row = rng.random((slots, m)).astype(np.float32)
        col = rng.random((slots, n)).astype(np.float32)
        pairs = row[:, :, None] + col[:, None, :]
        thr = np.quantile(pairs.reshape(slots, -1), 0.45,
                          axis=1).astype(np.float32)
        g, row, col, thr = (torch.from_numpy(a).to(device)
                            for a in (g, row, col, thr))
        leaves.append((g.to(dtype), row, col, thr,
                       torch.tensor(0.1, device=device)))
    return leaves


def _want_mask(leaf, s, drop_zeros, cap):
    """The compacted entries of pair (leaf, s): kept (and nonzero), the
    first ``cap`` of them in row-major order, as a flat 0/1 mask."""
    g, row, col, thr, rest = (t.cpu() for t in leaf)
    keep = ((row[s][:, None] + col[s][None, :]) + rest > thr[s])
    if drop_zeros:
        keep &= g[s].float() != 0
    flat = keep.reshape(-1).numpy().astype(np.uint8)
    flat[np.flatnonzero(flat)[cap:]] = 0
    return flat


def _scatter_all(leaves, drop_zeros, forms_cycle):
    """(count pass, counts, [(capacities, forms, views, coo-form views)])
    over the count pass's pairs at three capacities: the count, half of
    it and past it (a tail); the first launch of each takes
    ``forms_cycle`` pair by pair."""
    cc = sm.compact_count(leaves, drop_zeros=drop_zeros)
    counts = cc.counts.tolist()
    forms = [forms_cycle[k % len(forms_cycle)] for k in range(len(counts))]
    runs = []
    for caps in (counts, [c // 2 for c in counts], [c + 3 for c in counts]):
        before = sm.compact_bitmap_pairs
        _, views = sm.compact_scatter(cc, caps, None, forms)
        assert sm.compact_bitmap_pairs - before == forms.count("bitmap")
        _, coo = sm.compact_scatter(cc, caps)
        runs.append((caps, forms, views, coo))
    return cc, counts, runs


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.card)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_scatter_bitmap_form(case, device):
    """Every bitmap pair's bitmap is ``np.packbits`` of its compacted
    entries (the first min(count, cap) kept-and-nonzero ones; a
    zero-padded last byte) and its values are bitwise the coo form's;
    a coo pair in the same launch is the coo form's; on the card, every
    view is bitwise the CPU route's."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on one")
    shapes, _, drop_zeros, forms_cycle, _ = CASES[case]
    leaves = _leaves(case, device)
    cc, counts, runs = _scatter_all(leaves, drop_zeros, forms_cycle)
    if case == "all_zero":
        assert counts[1] == 0
    if device == "cuda":
        _, cpu_counts, cpu_runs = _scatter_all(_leaves(case, "cpu"),
                                               drop_zeros, forms_cycle)
        assert counts == cpu_counts
        for (_, _, views, coo), (_, _, cviews, ccoo) in zip(runs, cpu_runs):
            for got, want in zip(views + coo, cviews + ccoo):
                assert got[0].dtype == want[0].dtype
                assert torch.equal(got[0].cpu(), want[0])
                assert got[1].cpu().numpy().tobytes() == \
                    want[1].numpy().tobytes()
    for caps, forms, views, coo in runs:
        for k, ((l, s), cap, form) in enumerate(zip(cc.pairs, caps, forms)):
            head, vals = (t.cpu() for t in views[k])
            cidx, cvals = (t.cpu() for t in coo[k])
            assert vals.numpy().tobytes() == cvals.numpy().tobytes()
            mask = _want_mask(leaves[l], s, drop_zeros, cap)
            if form == "coo":
                assert torch.equal(head, cidx)
                continue
            m, n = shapes[l][1:]
            assert head.dtype == torch.uint8
            assert head.numel() == -(-m * n // 8)
            assert np.array_equal(head.numpy(), np.packbits(mask))
            assert np.array_equal(np.flatnonzero(mask),
                                  cidx[:min(cap, counts[k])].numpy())


def test_compact_scatter_refuses_unknown_forms():
    leaf = (torch.ones(4, 5), torch.zeros(4), torch.zeros(5), -1.0, 0.0)
    cc = sm.compact_count([leaf, leaf])
    for forms in (["bitmap"], ["coo", "zip"]):
        with pytest.raises(ValueError, match="form"):
            sm.compact_scatter(cc, [3, 3], None, forms)
    sm.reset_launches()
    sm.compact_scatter(cc, [20, 20], None, ["coo", "coo"])
    assert sm.compact_bitmap_pairs == 0
    sm.compact_scatter(cc, [20, 20], None, ["bitmap", "coo"])
    assert sm.compact_bitmap_pairs == 1
    sm.reset_launches()
    assert sm.compact_bitmap_pairs == 0
