#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on past
its own failure:

1. device — needs a CUDA device; prints the card's name and power limit
   (nvidia-smi) and the torch/CUDA versions.
2. build — compiles the four Hopper kernels from ``src/repro_torch/
   kernels/csrc`` with nvcc (one process per source, in parallel).
3. kernels vs plain — each kernel against its plain PyTorch version on
   the card, at the main path's shapes and ragged ones: channel_norm to
   rtol 1e-5 / atol 1e-6 and bitwise equal across two launches, single
   leaves and leaf tables of mixed shapes (one launch);
   select_mask bitwise (values, mask, count) and select_compact bitwise
   (idx, vals, count) over several thresholds, an exact tie, rest in
   {0, 0.37}, -inf scores, drop_zeros on and off and a capacity below the
   count; the same for leaf tables (K2 one launch, K3 one count and one
   scatter launch over mixed shapes, capacities at size, half the count
   and the count); slot-stacked tables of S in {1, 3, 5, 8} slots (the
   batched engine's rounds; layer 0's zero row shared by every slot),
   fp32 and bf16, each slot also bitwise its one-slot launch and every
   launch bitwise a second one; apoz bitwise at the SCBFwP path's shapes
   with an all-zero column, -0.0 and NaN, single leaves and a table a
   validation batch (one launch, counts and fractions).  Then times
   kernel and plain version (and apoz's library call): K1, K2 and K3 a
   round of 5 slots (the main path's unit; K3 at capacity M*N and on the
   encoder's route) and a client pass at a time (as one table and as
   single-leaf calls, K3 also on the encoder's route), K4 a prune step
   at a time (a table a batch, and single leaves), each with its device
   time from the profiler (and K4's memsets); a round's device time with
   L2 flushed between calls, and back to back beside it.
4. main path at full width — the synthetic cohort (30,760 × 2,917),
   MLP 2917-256-64-1, 5 IID clients, 2 local epochs, batch 256, upload
   rate 0.10, through ``repro_torch.core.scbf.run_federated`` on cuda,
   on the batched engine (the default): 2 SCBF loops, 2 FedAvg loops, 8
   loops each of SCBFwP reshape and SCBFwP mask with compaction (prune
   rate 0.10, total 0.47: 150 of the 320 hidden neurons go in 7 steps);
   then on the sequential engine 2 SCBF loops, held against the batched
   run (bytes and upload fractions equal, AUC and final weights to 1e-5;
   the weight-mask entries that flip are counted), 1 FedAvg loop and 8
   loops each of SCBFwP reshape and mask with compaction; back on the
   batched engine 2 SCBF loops with DP (noise
   multiplier 1.0, clip 1.0: ε finite and rising, every payload's
   nonzeros on exactly its reveal masks), and 3 SCBF loops on Dirichlet
   shards (α = 0.5) with sample_fraction 0.6 (the masked loss, 3
   participants in 4 slots a round).  The launch counts are set to 0
   before each run and read after it: a batched run launches K1, K2 and
   K3's count once a round, K3's scatter once a round whose uploads hold
   a coo or bitmap weight leaf; a sequential run the same once a client
   pass; K4 prune steps × 2 validation batches (the codec mix is
   logged).
5. fused round loop at full width — ``fuse_rounds`` = 2 on the batched
   engine, each round one replay of a captured CUDA graph: SCBF 4 loops
   beside the per-round run of the same 4 loops (bytes and upload
   fractions equal, final weights to 1e-5 with the difference and
   whether it is bitwise logged, shipped-support flips counted), its
   second chunk under ``torch.cuda.set_sync_debug_mode("error")``, its
   launches asserted (2 replays a chunk of 2 rounds and no wrapper
   launch inside it, K3's count once an emission, a run's K1 and K2 the
   capture's warm-up calls) and one capture; FedAvg 2 loops (1e-5 of the
   main path's per-round FedAvg run, one capture); SCBFwP
   mask 8 loops (one-round chunks while pruning; hidden sizes the
   per-round run's; at most 2 captures); SCBF with DP 2 loops (ε the
   per-round run's, every revealed entry shipped noised but exact-zero
   draws); then torch.profiler over one steady fused chunk (its replays
   and its emission apart: busy share, copies, top kernels; its kernel
   events must show K1 and K2 once a replay) and over one
   per-round SCBFwP mask loop (with the host seconds of its parts).
6. C1 — one batched round of 256 participants at the paper's widths
   (the cohort split 256 ways, batch 32): one launch each of K1 (its
   workspace past the 2^22 words the library once held), K2 and K3's
   count, and every slot's selection and encoding bitwise its one-slot
   calls.
7. profile — torch.profiler over one more full-width loop of SCBF on
   each engine and of SCBFwP: the device's busy share, the host-device
   copies and the kernels that take its time.
8. small-input agreement — SCBF, SCBF with DP (normals injected) and
   SCBFwP (mask, compacted) on the batched engine, SCBFwP (mask,
   compacted) on the sequential one, and fused SCBF with DP and fused
   SCBFwP (mask, compacted), on cuda and on the CPU (whose plain path the
   CPU tests hold against the JAX reference), from the same initial
   weights and permutations.
9. the card line, the kernel report line and the final ok line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
MAIN_SHAPES = [(2917, 256), (256, 64), (64, 1)]
CHECK_SHAPES = MAIN_SHAPES + [(33, 257), (7, 9), (1024, 128)]
# SCBFwP's APoZ calls: the 3,076 validation rows in batches of 2048 + 1028,
# over the two hidden layers at their full widths
APOZ_SHAPES = [(2048, 256), (2048, 64), (1028, 256), (1028, 64)]
K_LOOPS, K_CLIENTS = 2, 5
WP_LOOPS, PRUNE_RATE, PRUNE_TOTAL = 8, 0.10, 0.47
WP_STEPS, WP_HIDDEN = 7, 170          # 320 hidden neurons, 150 pruned
VAL_BATCHES, HIDDEN_LAYERS = 2, 2
# slot-stacked tables: the batched engine's rounds (S slots a leaf)
SLOTS = (1, 3, 5, 8)
SLOT_SHAPES = MAIN_SHAPES + [(33, 257)]
ROUND_SLOTS = K_CLIENTS               # a round of the main path
DP = dict(dp_noise_multiplier=1.0, dp_clip_norm=1.0)
DIRICHLET = dict(partition="dirichlet", dirichlet_alpha=0.5,
                 sample_fraction=0.6)
DIR_LOOPS = 3
FLUSH_BYTES = 256 << 20               # written between timed calls: > L2
FUSE_LOOPS, FUSE = 4, 2               # the fused SCBF run: 2 chunks of 2
BIG_ROUND, BIG_BATCH = 256, 32        # C1: one round of 256 participants


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device milliseconds per call, by CUDA events over ``iters``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(*fns) -> tuple:
    """Two functions: (plain_ms, kernel_ms), timed plain, kernel, kernel,
    plain.  More: each one's ms, timed in the order given."""
    if len(fns) == 2:
        p1, k1, k2, p2 = (cuda_ms(f) for f in fns + fns[::-1])
        return (p1 + p2) / 2, (k1 + k2) / 2
    return tuple(cuda_ms(f) for f in fns)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_channel_norm_and_select_mask(torch, gen) -> tuple:
    """K1 and K2 against their plain versions; (K1 max abs err, K2 max abs
    err)."""
    from repro_torch.core.channels import quantile
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    err_cn = err_sm = 0.0
    checks = 0
    for shape in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(shape, generator=gen).to(dtype).cuda()
            row, col = cn.channel_norms(g)
            row2, col2 = cn.channel_norms(g)
            prow, pcol = cn.channel_norms_plain(g)
            torch.cuda.synchronize()
            torch.testing.assert_close(row, prow, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(col, pcol, rtol=1e-5, atol=1e-6)
            if not (torch.equal(row, row2) and torch.equal(col, col2)):
                raise AssertionError(f"channel_norm not deterministic at "
                                     f"{shape} {dtype}")
            err_cn = max(err_cn, (row - prow).abs().max().item(),
                         (col - pcol).abs().max().item())
            srow, scol, thrs = _scores_and_thresholds(torch, quantile, prow,
                                                      pcol)
            for thr in thrs:
                for rest in (0.0, 0.37):
                    rest_t = torch.tensor(rest, device="cuda")
                    out, mask, cnt = sm.select_mask(g, srow, scol, thr,
                                                    rest_t)
                    pout, pmask, pcnt = sm.select_mask_plain(g, srow, scol,
                                                             thr, rest_t)
                    torch.cuda.synchronize()
                    if not (torch.equal(out, pout)
                            and torch.equal(mask, pmask)
                            and int(cnt) == int(pcnt)):
                        raise AssertionError(
                            f"select_mask differs from plain at {shape} "
                            f"{dtype} thr={float(thr)} rest={rest}")
                    err_sm = max(err_sm, (out.float() - pout.float())
                                 .abs().max().item())
                    checks += 1
    log(f"kernels vs plain: channel_norm {2 * len(CHECK_SHAPES)} cases "
        f"(max abs err {err_cn:.3g}, deterministic), select_mask {checks} "
        f"cases bitwise")
    return err_cn, err_sm


def _scores_and_thresholds(torch, quantile, row, col):
    """Scores with -inf on some rows and columns (pruned neurons) and
    thresholds at three quantiles of their finite pair sums plus an exact
    tie."""
    srow, scol = row.clone(), col.clone()
    srow[::7] = float("-inf")
    if scol.shape[0] > 1:
        scol[1::5] = float("-inf")
    pairs = (srow[:, None] + scol[None, :]).reshape(-1)
    finite = pairs[torch.isfinite(pairs)]
    thrs = [quantile(finite, q) for q in (0.1, 0.5, 0.9)]
    thrs.append(finite[finite.numel() // 2].clone())   # exact tie
    return srow, scol, thrs


def check_select_compact(torch, gen) -> float:
    """K3 bitwise against its plain version; its max abs error (0)."""
    from repro_torch.core.channels import quantile
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    checks = 0
    err = 0.0
    # (4099, 1031) spans more than 1024 tiles: the scan's carry
    for shape in CHECK_SHAPES + [(4099, 1031)]:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(shape, generator=gen).to(dtype).cuda()
            g[::3] = 0                  # kept-but-zero entries
            prow, pcol = cn.channel_norms_plain(g)
            srow, scol, thrs = _scores_and_thresholds(torch, quantile,
                                                      prow, pcol)
            for thr in thrs:
                for rest in (0.0, 0.37):
                    rest_t = torch.tensor(rest, device="cuda")
                    for drop in (False, True):
                        full = sm.select_compact_plain(g, srow, scol, thr,
                                                       rest_t, g.numel(),
                                                       drop)
                        caps = [g.numel(), max(int(full[2]) // 2, 0),
                                int(full[2])]
                        for cap in caps:
                            got = sm.select_compact(g, srow, scol, thr,
                                                    rest_t, capacity=cap,
                                                    drop_zeros=drop)
                            want = sm.select_compact_plain(
                                g, srow, scol, thr, rest_t, cap, drop)
                            torch.cuda.synchronize()
                            if not all(torch.equal(a, b)
                                       for a, b in zip(got, want)):
                                raise AssertionError(
                                    f"select_compact differs from plain at "
                                    f"{shape} {dtype} thr={float(thr)} "
                                    f"rest={rest} drop_zeros={drop} "
                                    f"capacity={cap}")
                            err = max(err, (got[1] - want[1]).abs().max()
                                      .item() if cap else 0.0)
                            checks += 1
    log(f"kernels vs plain: select_compact {checks} cases bitwise "
        f"(idx, vals, count)")
    return err


def _same(torch, got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def check_leaf_tables(torch, gen) -> None:
    """K2 and K3 over leaf tables — one launch (K2), one count and one
    scatter launch (K3) for a table of mixed shapes — bitwise against the
    plain versions leaf by leaf.  Each table holds the main path's and
    the check shapes, one leaf whose g starts one element past an
    alignment (the scalar path at N % 4 == 0) and one leaf of more than
    1,024 tiles (K3's offsets from the count launch); -inf scores, a
    threshold per leaf at a quantile or an exact tie, rest 0 or 0.37 in
    turn, kept-but-zero rows of g.  K3 scatters at capacity M*N, at half
    the count and at the count, over all leaves and over every other."""
    from repro_torch.core.channels import quantile
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    shapes = CHECK_SHAPES + [(256, 64)]             # the last misaligned
    checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        gs = []
        for k, (m, n) in enumerate(shapes + [(4099, 1031)]):
            flat = torch.randn(m * n + 1, generator=gen).to(dtype).cuda()
            g = flat[1:].view(m, n) if k == len(shapes) - 1 else \
                flat[:-1].view(m, n)
            g[::3] = 0
            gs.append(g)
        parts = []
        for g in gs:
            prow, pcol = cn.channel_norms_plain(g)
            parts.append(_scores_and_thresholds(torch, quantile, prow, pcol))
        for t in range(4):                 # the quantiles, then the ties
            leaves = [(g, srow, scol, thrs[t],
                       torch.tensor(0.37 * ((t + k) % 2), device="cuda"))
                      for k, (g, (srow, scol, thrs)) in
                      enumerate(zip(gs, parts))]
            outs, masks, counts = sm.select_mask_leaves(leaves)
            for k, leaf in enumerate(leaves):
                want = sm.select_mask_plain(*leaf)
                if not _same(torch, (outs[k], masks[k], counts[k]), want):
                    raise AssertionError(f"select_mask table differs from "
                                         f"plain at leaf {k} "
                                         f"{tuple(leaf[0].shape)} {dtype}")
                checks += 1
            for drop in (False, True):
                cc = sm.compact_count(leaves, drop_zeros=drop)
                full = [sm.select_compact_plain(*leaf, leaf[0].numel(), drop)
                        for leaf in leaves]
                nnz = [int(c) for _, _, c in full]
                if cc.counts.tolist() != nnz:
                    raise AssertionError(f"select_compact table counts "
                                         f"{cc.counts.tolist()} != {nnz}")
                odd = list(range(1, len(leaves), 2))
                for which, caps in (
                        (None, [leaf[0].numel() for leaf in leaves]),
                        (None, [c // 2 for c in nnz]), (None, nnz),
                        (odd, [nnz[k] for k in odd])):
                    _, views = sm.compact_scatter(cc, caps, which)
                    for k, cap, (idx, vals) in zip(
                            which or range(len(leaves)), caps, views):
                        want = sm.select_compact_plain(*leaves[k], cap, drop)
                        if not _same(torch, (idx, vals), want):
                            raise AssertionError(
                                f"select_compact table differs from plain "
                                f"at leaf {k} {tuple(leaves[k][0].shape)} "
                                f"{dtype} drop_zeros={drop} capacity={cap}")
                        checks += 1
    torch.cuda.synchronize()
    log(f"kernels vs plain: leaf tables, {checks} leaf cases bitwise "
        f"(select_mask one launch a table, select_compact count + "
        f"scatter)")


def check_channel_norm_tables(torch, gen) -> float:
    """K1 over leaf tables — one launch for a table of mixed shapes — to
    rtol 1e-5 / atol 1e-6 against the plain version leaf by leaf, and
    bitwise equal across two launches.  The table holds the main path's
    and the check shapes, one leaf whose g starts one element past an
    alignment (the scalar path at N % 4 == 0) and one of many tiles and
    strips (4099 x 1031); fp32 and bf16.  Returns the max abs error."""
    from repro_torch.kernels import channel_norm as cn

    shapes = CHECK_SHAPES + [(256, 64), (4099, 1031)]
    err, checks = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        gs = []
        for k, (m, n) in enumerate(shapes):
            flat = torch.randn(m * n + 1, generator=gen).to(dtype).cuda()
            gs.append(flat[1:].view(m, n) if k == len(CHECK_SHAPES) else
                      flat[:-1].view(m, n))
        for _ in range(2):              # the main path's table, then all
            got = cn.channel_norms_leaves(gs)
            again = cn.channel_norms_leaves(gs)
            for g, (row, col), (row2, col2) in zip(gs, got, again):
                prow, pcol = cn.channel_norms_plain(g)
                torch.testing.assert_close(row, prow, rtol=1e-5, atol=1e-6)
                torch.testing.assert_close(col, pcol, rtol=1e-5, atol=1e-6)
                if not (torch.equal(row, row2) and torch.equal(col, col2)):
                    raise AssertionError(f"channel_norm table not "
                                         f"deterministic at {tuple(g.shape)} "
                                         f"{dtype}")
                err = max(err, (row - prow).abs().max().item(),
                          (col - pcol).abs().max().item())
                checks += 1
            gs = gs[:len(MAIN_SHAPES)]
    torch.cuda.synchronize()
    log(f"kernels vs plain: channel_norm leaf tables, {checks} leaf cases "
        f"(max abs err {err:.3g}, deterministic, one launch a table)")
    return err


def _slot_operands(torch, quantile, gs, rest_for=None):
    """Slot-stacked edge operands of a table of (S, M, N) matrices, as the
    batched engine gives them: layer 0 tests against one zero row vector
    shared by every slot (slot stride 0), the others against their own
    (S, M) scores; -inf scores on some rows and columns, a threshold a
    slot at a quantile of its pair sums or an exact tie, rest 0 or 0.37
    by slot."""
    from repro_torch.kernels import channel_norm as cn

    leaves = []
    for l, g in enumerate(gs):
        s_count, m, _ = g.shape
        prow, pcol = cn.channel_norms_plain(g)
        parts = [_scores_and_thresholds(torch, quantile, prow[s], pcol[s])
                 for s in range(s_count)]
        row = torch.zeros(m, device="cuda") if l == 0 else \
            torch.stack([p[0] for p in parts])
        col = torch.stack([p[1] for p in parts])
        thr = torch.stack([p[2][(s + l) % 4] for s, p in enumerate(parts)])
        rest = torch.tensor([0.37 * ((s + l) % 2) for s in range(s_count)],
                            device="cuda")
        leaves.append((g, row, col, thr, rest))
    return leaves


def check_slot_tables(torch, gen) -> float:
    """K1, K2 and K3 over slot-stacked tables — a round of the batched
    engine: S in SLOTS slots of the main path's three matrices and a
    ragged 33 x 257, fp32 and bf16, kept-but-zero rows of g.  K1 to rtol
    1e-5 / atol 1e-6 against the plain version (another summation order),
    K2 and K3 bitwise against it; all three bitwise against the one-slot
    launch of each slot and across two launches.  K3 scatters every pair
    at its count and at M*N, and every other pair at half its count.
    Returns K1's max abs error."""
    from repro_torch.core.channels import quantile
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    err, cases = 0.0, {"channel_norm": 0, "select_mask": 0,
                       "select_compact": 0}
    for s_count in SLOTS:
        for dtype in (torch.float32, torch.bfloat16):
            gs = []
            for m, n in SLOT_SHAPES:
                g = torch.randn((s_count, m, n), generator=gen).to(dtype)
                g[:, ::3] = 0
                gs.append(g.cuda())
            got = cn.channel_norms_leaves(gs)
            again = cn.channel_norms_leaves(gs)
            ones = [cn.channel_norms_leaves([g[s] for g in gs])
                    for s in range(s_count)]
            for l, g in enumerate(gs):
                prow, pcol = cn.channel_norms_plain(g)
                torch.testing.assert_close(got[l][0], prow, rtol=1e-5,
                                           atol=1e-6)
                torch.testing.assert_close(got[l][1], pcol, rtol=1e-5,
                                           atol=1e-6)
                if not (_same(torch, got[l], again[l]) and all(
                        _same(torch, (got[l][0][s], got[l][1][s]), ones[s][l])
                        for s in range(s_count))):
                    raise AssertionError(f"channel_norm slots not bitwise "
                                         f"(S={s_count} {tuple(g.shape)} "
                                         f"{dtype})")
                err = max(err, (got[l][0] - prow).abs().max().item(),
                          (got[l][1] - pcol).abs().max().item())
                cases["channel_norm"] += s_count
            leaves = _slot_operands(torch, quantile, gs)
            outs, masks, counts = sm.select_mask_leaves(leaves)
            outs2, masks2, counts2 = sm.select_mask_leaves(leaves)
            per_slot = [sm.select_mask_leaves([sm.leaf_slot(leaf, s)
                                               for leaf in leaves])
                        for s in range(s_count)]
            for l, leaf in enumerate(leaves):
                mine = (outs[l], masks[l],
                        counts[l * s_count:(l + 1) * s_count])
                if not (_same(torch, mine, sm.select_mask_plain(*leaf)) and
                        _same(torch, mine, (outs2[l], masks2[l], counts2[
                            l * s_count:(l + 1) * s_count])) and
                        all(_same(torch, (outs[l][s], masks[l][s],
                                          counts[l * s_count + s]),
                                  (o[l], m[l], c[l]))
                            for s, (o, m, c) in enumerate(per_slot))):
                    raise AssertionError(f"select_mask slots differ "
                                         f"(S={s_count} leaf {l} {dtype})")
                cases["select_mask"] += s_count
            for drop in (False, True):
                cc = sm.compact_count(leaves, drop_zeros=drop)
                nnz = cc.counts.tolist()
                plain = [int(sm.select_compact_plain(
                    *sm.leaf_slot(leaves[l], s), 0, drop)[2])
                    for l, s in cc.pairs]
                if nnz != plain:
                    raise AssertionError(f"select_compact slot counts {nnz} "
                                         f"!= {plain}")
                odd = list(range(1, len(cc.pairs), 2))
                sizes = [leaves[l][0][s].numel() for l, s in cc.pairs]
                at_count = None
                for which, caps in ((None, nnz), (None, sizes),
                                    (odd, [nnz[k] // 2 for k in odd])):
                    _, views = sm.compact_scatter(cc, caps, which)
                    cc2 = sm.compact_count(leaves, drop_zeros=drop)
                    _, views2 = sm.compact_scatter(cc2, caps, which)
                    for k, cap, v, v2 in zip(which or range(len(nnz)), caps,
                                             views, views2):
                        l, s = cc.pairs[k]
                        want = sm.select_compact_plain(
                            *sm.leaf_slot(leaves[l], s), cap, drop)
                        if not (_same(torch, v, want) and
                                _same(torch, v, v2)):
                            raise AssertionError(
                                f"select_compact slot pair {(l, s)} differs "
                                f"(S={s_count} {dtype} drop_zeros={drop} "
                                f"capacity={cap})")
                        cases["select_compact"] += 1
                    if at_count is None:
                        at_count = views
                for s in range(s_count):       # the one-slot launches
                    one = [sm.leaf_slot(leaf, s) for leaf in leaves]
                    cc1 = sm.compact_count(one, drop_zeros=drop)
                    caps = [nnz[cc.pairs.index((l, s))]
                            for l in range(len(leaves))]
                    _, views1 = sm.compact_scatter(cc1, caps)
                    for l, v1 in enumerate(views1):
                        if not _same(torch, v1,
                                     at_count[cc.pairs.index((l, s))]):
                            raise AssertionError(
                                f"select_compact slot {s} of leaf {l} is "
                                f"not its one-slot launch (S={s_count} "
                                f"{dtype} drop_zeros={drop})")
    torch.cuda.synchronize()
    log(f"kernels vs plain: slot tables S in {list(SLOTS)} over "
        f"{len(SLOT_SHAPES)} leaves, fp32 and bf16 — channel_norm "
        f"{cases['channel_norm']} slot cases (max abs err {err:.3g}), "
        f"select_mask {cases['select_mask']} and select_compact "
        f"{cases['select_compact']} pair cases bitwise; every slot bitwise "
        f"its one-slot launch and across two launches")
    return err


def _apoz_input(torch, gen, shape, offset: int = 0):
    """ReLU activations with -0.0 (a zero), NaN (not one) and an all-zero
    column; ``offset`` starts the matrix that many floats into its
    storage."""
    b, n = shape
    a = torch.relu(torch.randn(b * n + offset, generator=gen)).cuda()
    a = a[offset:].view(b, n)
    a[0] = -0.0
    a[1, ::2] = float("nan")
    a[:, n // 2] = 0.0
    return a


def check_apoz(torch, gen) -> float:
    """K4 bitwise against its plain version: single leaves, and leaf
    tables (one launch) with the fractions fl(count * fl(1/B)) — a table
    a validation batch of the SCBFwP path, and a ragged one.  Its max abs
    error (0)."""
    import numpy as np

    from repro_torch.kernels import apoz as az

    checks = 0
    for shape in APOZ_SHAPES + [(33, 257), (7, 9), (130, 3)]:
        a = _apoz_input(torch, gen, shape)
        got, want = az.apoz_counts(a), az.apoz_counts_plain(a)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or \
                int(got[shape[1] // 2]) != shape[0]:
            raise AssertionError(f"apoz_counts differs from plain at "
                                 f"{shape}")
        checks += 1
    tables = [APOZ_SHAPES[:HIDDEN_LAYERS], APOZ_SHAPES[HIDDEN_LAYERS:],
              [(33, 257), (7, 9), (130, 3), (64, 64)]]
    for shapes in tables:
        acts = [_apoz_input(torch, gen, s, int(s == (64, 64)))
                for s in shapes]
        recip = float(np.float32(1.0) / np.float32(shapes[0][0]))
        for r in (recip, None):
            counts, frac = az.apoz_counts_leaves(acts, r)
            pcounts, pfrac = az.apoz_leaves_plain(acts, r)
            torch.cuda.synchronize()
            if not all(torch.equal(c, p) for c, p in zip(counts, pcounts)) \
                    or (r is None) != (frac is None) or \
                    (frac is not None and not torch.equal(frac, pfrac)):
                raise AssertionError(f"apoz table differs from plain at "
                                     f"{shapes} recip={r}")
            checks += len(shapes)
    log(f"kernels vs plain: apoz {checks} cases bitwise (counts, and "
        f"fractions on the table route)")
    return 0.0


def device_us(torch, fn, names, launches: int, iters: int = 50,
              flush: bool = False) -> tuple:
    """(device µs per call in the kernels whose names hold one of
    ``names``, device µs per call in memsets), from torch.profiler over
    ``iters`` calls of ``fn``, which launches those kernels ``launches``
    times a call.  With ``flush``, FLUSH_BYTES are written between calls
    (a fill kernel, not counted), so each call meets its inputs in HBM and
    not in the 50 MB L2, as the main path's round does after a round's
    training.  A window whose count of those kernels falls short (the
    profiler lost events) is measured again, four times at most; then, or
    if the profiler records no CUDA event, (None, None): not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scratch = (torch.empty(FLUSH_BYTES // 4, device="cuda") if flush
               else None)
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if scratch is not None:
                    scratch.fill_(0.0)
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        ours = [e for e in events if any(s in e.name for s in names)]
        if len(ours) == launches * iters:
            return (sum(e.time_range.elapsed_us() for e in ours) / iters,
                    sum(e.time_range.elapsed_us() for e in events
                        if "Memset" in e.name) / iters)
        log(f"profile window of {names}: {len(ours)} kernel events, want "
            f"{launches * iters}; measuring again")
    return None, None


def time_rounds(torch, gen) -> dict:
    """K1, K2 and K3 timed a round of the batched engine at a time:
    ROUND_SLOTS slots of the main path's three matrices (fp32), one table
    launch each (K3: count + scatter of every pair at capacity M*N with
    drop_zeros, and the encoder's route: count, the counts read on the
    host, scatter of the coo and bitmap pairs at their counts), beside
    the plain versions (a loop over slots); profiler device µs with each
    window's event count checked, with L2 flushed between calls (the
    reported device time) and without (back to back, L2-warm), and the
    bound at S x a pass's bytes.  Thresholds at the 0.9 quantile of each
    slot's pair sums."""
    from repro_torch.comm.wire import cheapest_bytes
    from repro_torch.core.channels import quantile
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    s_count = ROUND_SLOTS
    leaves, nbytes, flops = [], {}, {}
    for m, n in MAIN_SHAPES:
        g = torch.randn((s_count, m, n), generator=gen).cuda()
        row, col = cn.channel_norms_plain(g)
        thr = torch.stack([quantile((row[s][:, None] + col[s][None, :])
                                    .reshape(-1), 0.9)
                           for s in range(s_count)])
        leaves.append((g, row, col, thr,
                       torch.zeros(s_count, device="cuda")))
        for name, b, f in (
                ("channel_norm", 4 * m * n + 4 * (m + n), 3 * m * n),
                ("select_mask", 4 * m * n + 4 * (m + n) + 8 + 4 * m * n
                 + m * n + 4, 3 * m * n),
                ("select_compact", 4 * m * n + 4 * (m + n) + 8 + 8 * m * n
                 + 4, 4 * m * n)):
            nbytes[name] = nbytes.get(name, 0) + s_count * b
            flops[name] = flops.get(name, 0) + s_count * f
    gs = [leaf[0] for leaf in leaves]
    cc = sm.compact_count(leaves, drop_zeros=True)
    pairs, nnz = cc.pairs, cc.counts.tolist()
    sizes = [leaves[l][0][s].numel() for l, s in pairs]
    sparse = [k for k, (c, size) in enumerate(zip(nnz, sizes))
              if c and cheapest_bytes(c, size)[0] != "dense"]

    def compact_table():
        sm.compact_scatter(sm.compact_count(leaves, drop_zeros=True), sizes)

    def compact_encoder():
        c = sm.compact_count(leaves, drop_zeros=True)
        counts = c.counts.tolist()
        sm.compact_scatter(c, [counts[k] for k in sparse], sparse)

    routes = {
        "channel_norm": (lambda: [cn.channel_norms_plain(g) for g in gs],
                         lambda: cn.channel_norms_leaves(gs),
                         ("channel_norms_kernel",), 1),
        "select_mask": (lambda: [sm.select_mask_plain(*leaf)
                                 for leaf in leaves],
                        lambda: sm.select_mask_leaves(leaves),
                        ("select_mask_kernel",), 1),
        "select_compact": (
            lambda: [sm.select_compact_plain(*sm.leaf_slot(leaves[l], s), size,
                                             True)
                     for (l, s), size in zip(pairs, sizes)],
            compact_table, ("compact_",), 2),
    }
    out = {}
    for name, (plain, kernel, names, launches) in routes.items():
        plain_ms, ms = in_turns(plain, kernel)
        bound, by = bound_ms(nbytes[name], flops[name])
        out[name] = {"slots": s_count, "ms": ms, "plain_ms": plain_ms,
                     "device_us": device_us(torch, kernel, names, launches,
                                            flush=True)[0],
                     "device_us_l2_warm": device_us(torch, kernel, names,
                                                    launches)[0],
                     "bound_ms": bound, "bound_by": by}
    enc_bytes = s_count * sum(4 * m * n + 4 * (m + n) + 12
                              for m, n in MAIN_SHAPES) \
        + sum(8 * nnz[k] for k in sparse)
    enc_bound, enc_by = bound_ms(enc_bytes, flops["select_compact"])
    out["select_compact"]["encoder"] = {
        "ms": cuda_ms(compact_encoder),
        "device_us": device_us(torch, compact_encoder, ("compact_",),
                               1 + bool(sparse), flush=True)[0],
        "device_us_l2_warm": device_us(torch, compact_encoder,
                                       ("compact_",), 1 + bool(sparse))[0],
        "bound_us": enc_bound * 1e3, "bound_by": enc_by,
        "scattered_pairs": len(sparse)}
    return out


def time_kernels(torch, gen, errs: dict) -> list:
    """Kernel, plain version and library call timed in turns at the main
    path's shapes; the report rows (launches filled in later).  K1, K2
    and K3 are timed a client pass at a time (one leaf a weight matrix,
    fp32; K2 and K3 with the threshold at the 0.9 quantile of the pair
    sums): K1 and K2 as one table launch and as three single-leaf calls;
    K3 at capacity M*N with drop_zeros as one table (count + scatter
    launch) and as three single-leaf calls (PR 12's timing), and on the
    encoder's route: count, the counts read on the host, scatter of the
    coo and bitmap leaves at their counts.  K4 is timed a prune step at a
    time: a table a validation batch with the fractions (the main path's
    route) and four single-leaf count calls, beside the library's count
    of nonzeros; the memsets on each route are counted too."""
    import numpy as np

    from repro_torch.comm.wire import cheapest_bytes
    from repro_torch.core.channels import quantile
    from repro_torch.kernels import apoz as az
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    t = {k: {"plain": 0.0, "kernel": 0.0, "library": 0.0}
         for k in ("channel_norm", "select_mask", "select_compact", "apoz")}
    nbytes = dict.fromkeys(t, 0.0)
    flops = dict.fromkeys(t, 0.0)
    leaves = []
    for m, n in MAIN_SHAPES:
        g = torch.randn((m, n), generator=gen).cuda()
        row, col = cn.channel_norms_plain(g)
        thr = quantile((row[:, None] + col[None, :]).reshape(-1), 0.9)
        leaves.append((g, row, col, thr, torch.tensor(0.0, device="cuda")))
        nbytes["channel_norm"] += 4 * m * n + 4 * (m + n)
        flops["channel_norm"] += 3 * m * n
        nbytes["select_mask"] += 4 * m * n + 4 * (m + n) + 8 + 4 * m * n \
            + m * n + 4
        flops["select_mask"] += 3 * m * n
        nbytes["select_compact"] += 4 * m * n + 4 * (m + n) + 8 \
            + 8 * m * n + 4
        flops["select_compact"] += 4 * m * n
    gs = [leaf[0] for leaf in leaves]
    sizes = [g.numel() for g in gs]
    nnz = sm.compact_count(leaves, drop_zeros=True).counts.tolist()
    sparse = [k for k, (c, size) in enumerate(zip(nnz, sizes))
              if c and cheapest_bytes(c, size)[0] != "dense"]
    # one SCBFwP prune step: 2 validation batches x 2 hidden layers
    batches = []
    for k in range(VAL_BATCHES):
        shapes = APOZ_SHAPES[k * HIDDEN_LAYERS:(k + 1) * HIDDEN_LAYERS]
        acts = [torch.relu(torch.randn(s, generator=gen)).cuda()
                for s in shapes]
        batches.append((acts, float(np.float32(1.0) /
                                    np.float32(shapes[0][0]))))
        for b, n in shapes:
            nbytes["apoz"] += 4 * b * n + 8 * n      # counts and fractions
            flops["apoz"] += b * n

    def compact_table():
        sm.compact_scatter(sm.compact_count(leaves, drop_zeros=True), sizes)

    def compact_encoder():
        cc = sm.compact_count(leaves, drop_zeros=True)
        counts = cc.counts.tolist()
        sm.compact_scatter(cc, [counts[k] for k in sparse], sparse)

    layers, steps = len(MAIN_SHAPES), VAL_BATCHES * HIDDEN_LAYERS
    # plain, table route, single-leaf route, kernel names, launches a
    # call of the table and of the single-leaf route
    routes = {
        "channel_norm": (
            lambda: [cn.channel_norms_plain(g) for g in gs],
            lambda: cn.channel_norms_leaves(gs),
            lambda: [cn.channel_norms(g) for g in gs],
            ("channel_norms_kernel",), 1, layers),
        "select_mask": (
            lambda: [sm.select_mask_plain(*leaf) for leaf in leaves],
            lambda: sm.select_mask_leaves(leaves),
            lambda: [sm.select_mask(*leaf) for leaf in leaves],
            ("select_mask_kernel",), 1, layers),
        "select_compact": (
            lambda: [sm.select_compact_plain(*leaf, leaf[0].numel(), True)
                     for leaf in leaves],
            compact_table,
            lambda: [sm.select_compact(*leaf, capacity=leaf[0].numel(),
                                       drop_zeros=True) for leaf in leaves],
            ("compact_",), 2, 2 * layers),
        "apoz": (
            lambda: [az.apoz_leaves_plain(acts, r) for acts, r in batches],
            lambda: [az.apoz_counts_leaves(acts, r) for acts, r in batches],
            lambda: [az.apoz_counts(a) for acts, _ in batches for a in acts],
            ("apoz_leaves_kernel",), VAL_BATCHES, steps),
    }
    extra = {}
    for name, (plain, table, single, names, n_table, n_single) in \
            routes.items():
        p1, k1, s1, s2, k2, p2 = in_turns(plain, table, single, single,
                                          table, plain)
        t[name]["plain"] = (p1 + p2) / 2
        t[name]["kernel"] = (k1 + k2) / 2
        dev, memset = device_us(torch, table, names, n_table)
        dev1, memset1 = device_us(torch, single, names, n_single)
        extra[name] = {"ms_single_leaf": (s1 + s2) / 2,
                       "device_us": dev, "device_us_single_leaf": dev1,
                       "memset_us": memset, "memset_us_single_leaf": memset1}
    # the library's count of nonzeros per column: the complement of the
    # zero count, in one call a leaf
    t["apoz"]["library"] = cuda_ms(
        lambda: [torch.count_nonzero(a, dim=0)
                 for acts, _ in batches for a in acts])
    enc_bytes = sum(4 * m * n + 4 * (m + n) + 12 for m, n in MAIN_SHAPES) \
        + sum(8 * nnz[k] for k in sparse)
    enc_bound, enc_by = bound_ms(enc_bytes, flops["select_compact"])
    extra["select_compact"]["encoder"] = {
        "ms": cuda_ms(compact_encoder),
        "device_us": device_us(torch, compact_encoder, ("compact_",),
                               1 + bool(sparse))[0],
        "bound_us": enc_bound * 1e3, "bound_by": enc_by,
        "nnz": nnz, "scattered_leaves": sparse}
    main_txt = "+".join(f"{m}x{n}" for m, n in MAIN_SHAPES) + " fp32"
    apoz_txt = "+".join(f"{b}x{n}" for b, n in APOZ_SHAPES) + " fp32"
    meta = {
        # no one PyTorch call gives both the row and the column norms
        "channel_norm": ("src/repro/kernels/channel_norm.py:48",
                         main_txt + f", {ROUND_SLOTS} slots: one table "
                         "launch a round", None),
        "select_mask": ("src/repro/kernels/select_mask.py:123",
                        main_txt + f", {ROUND_SLOTS} slots: one table "
                        "launch a round", None),
        # no one PyTorch call compacts by a pairwise score test in order
        "select_compact": ("src/repro/kernels/select_mask.py:78",
                           main_txt + f", {ROUND_SLOTS} slots, capacity "
                           "M*N: one table a round (count + scatter "
                           "launch)", None),
        "apoz": ("src/repro/kernels/apoz.py:46",
                 apoz_txt + ", one table launch a batch with the fractions",
                 t["apoz"]["library"]),
    }
    # K1-K3 on the main path take a round (the batched engine's slot
    # tables): their row's ms, plain_ms and bound are a round's; a client
    # pass (the sequential engine's unit) is kept beside it
    rounds = time_rounds(torch, gen)
    report = []
    for name, (replaces, shape_txt, library) in meta.items():
        bound, by = bound_ms(nbytes[name], flops[name])
        row = {"ms": t[name]["kernel"], "plain_ms": t[name]["plain"],
               "bound_ms": bound, "bound_by": by}
        extra_row = dict(extra.get(name, {}))
        if name in rounds:
            extra_row = {"pass": {**row, **extra_row}}
            r = rounds[name]
            row = {k: r[k] for k in row}
            extra_row.update({k: v for k, v in r.items() if k not in row})
        report.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[name], **row,
            "library_ms": library, "shape": shape_txt, **extra_row})
    return report


def phase_kernels(torch) -> list:
    gen = torch.Generator().manual_seed(0)
    errs = {}
    errs["channel_norm"], errs["select_mask"] = \
        check_channel_norm_and_select_mask(torch, gen)
    errs["channel_norm"] = max(errs["channel_norm"],
                               check_channel_norm_tables(torch, gen))
    errs["select_compact"] = check_select_compact(torch, gen)
    check_leaf_tables(torch, gen)
    errs["channel_norm"] = max(errs["channel_norm"],
                               check_slot_tables(torch, gen))
    errs["apoz"] = check_apoz(torch, gen)
    return time_kernels(torch, gen, errs)


class PruneTimer:
    """Device-synchronised wall seconds of every ``Pruner.step`` and
    ``Pruner.compact`` call, keyed by call order, while installed."""

    def __init__(self, torch):
        from repro_torch.core.pruning import Pruner
        self.torch, self.cls, self.seconds = torch, Pruner, []
        self.saved = (Pruner.step, Pruner.compact)

    def _wrap(self, fn):
        def timed(pruner, params):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(pruner, params)
            self.torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out
        return timed

    def __enter__(self):
        self.cls.step = self._wrap(self.saved[0])
        self.cls.compact = self._wrap(self.saved[1])
        return self

    def __exit__(self, *exc):
        self.cls.step, self.cls.compact = self.saved


class RoundTap:
    """Every SCBF round an engine runs, while installed: the engine, the
    participants, their bucket of slots, whether the cohort is uniform,
    and the payloads and upload stats it returns.  With ``masks``, also
    every mask the channel selection returns (kept on the device: no
    sync inside the loop)."""

    def __init__(self, masks: bool = False):
        from repro_torch.core import selection as sel
        from repro_torch.fed import engine as fe
        self.sel, self.want_masks = sel, masks
        self.saved = {cls: cls.scbf_round
                      for cls in (fe.BatchedEngine, fe.SequentialEngine)}
        self.saved_select = sel.select_gradients
        self.rounds, self.selected = [], []

    def __enter__(self):
        from repro_torch.fed.cohort import bucket_size
        for cls, fn in self.saved.items():
            def tapped(eng, params, participants, *a, _fn=fn, **k):
                payloads, stats = _fn(eng, params, participants, *a, **k)
                p = len(participants)
                batched = eng.name == "batched"
                self.rounds.append({
                    "engine": eng.name, "participants": p,
                    "slots": bucket_size(p, eng.num_clients, eng.bucket)
                    if batched and p else p,
                    "uniform": eng.cohort.uniform if batched else None,
                    "payloads": payloads, "stats": stats})
                return payloads, stats
            cls.scbf_round = tapped
        if self.want_masks:
            def select(*a, **k):
                out = self.saved_select(*a, **k)
                self.selected.append([{k: v.clone() for k, v in m.items()
                                       if v is not None} for m in out[1]])
                return out
            self.sel.select_gradients = select
        return self

    def __exit__(self, *exc):
        for cls, fn in self.saved.items():
            cls.scbf_round = fn
        self.sel.select_gradients = self.saved_select

    def units(self) -> list:
        """The payload lists of each encoder call: a round (batched) or a
        client pass (sequential); empty rounds encode nothing."""
        out = []
        for r in self.rounds:
            if r["engine"] == "batched":
                out += [r["payloads"]] if r["participants"] else []
            else:
                out += [[p] for p in r["payloads"]]
        return out

    def mix(self) -> dict:
        """{layer: {codec: payloads}} over the weight leaves."""
        out = {}
        for unit in self.units():
            for payload in unit:
                for (l, k), lp in zip(payload.keys, payload.layers):
                    if k == "w":
                        per = out.setdefault(f"w{l}", {})
                        per[lp.codec] = per.get(lp.codec, 0) + 1
        return out

    def scatter_units(self) -> int:
        """Encoder calls with a coo or bitmap weight leaf that keeps an
        entry: the calls that launch the scatter."""
        return sum(any(k == "w" and lp.codec != "dense" and lp.nnz
                       for payload in unit
                       for (_, k), lp in zip(payload.keys, payload.layers))
                   for unit in self.units())

    def client_masks(self) -> list:
        """Per (loop, participant) the masks selection returned (layer
        dicts), whatever the engine."""
        out = []
        for r, masks in zip(self._select_rounds(), self.selected):
            if r["engine"] == "batched":
                out += [[{k: v[s] for k, v in m.items()} for m in masks]
                        for s in range(r["participants"])]
            else:
                out.append(masks)
        return out

    def _select_rounds(self) -> list:
        rows = []
        for r in self.rounds:
            if r["engine"] == "batched":
                rows += [r] if r["participants"] else []
            else:
                rows += [r] * r["participants"]
        return rows


def _launch_counts() -> dict:
    from repro_torch.kernels import apoz as az
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm
    return {"channel_norm": cn.launches, "select_mask": sm.mask_launches,
            "select_compact_count": sm.compact_count_launches,
            "select_compact_scatter": sm.compact_scatter_launches,
            "apoz": az.launches}


def _reset_launches() -> None:
    from repro_torch.kernels import apoz as az
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm
    cn.reset_launches()
    sm.reset_launches()
    az.reset_launches()


def phase_main_path(torch, card: str):
    """The runs of the main path at full width (the batched engine unless
    a run says otherwise), each with its checks; then SCBF on the two
    engines held against each other, the DP run's payloads against its
    reveal masks, and the Dirichlet run's buckets."""
    from repro_torch.config import FedConfig, ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import generate_cohort

    t0 = time.perf_counter()
    cohort = generate_cohort()
    log(f"cohort {cohort.x_train.shape[0]}+{cohort.x_val.shape[0]}+"
        f"{cohort.x_test.shape[0]} x {cohort.num_features} generated in "
        f"{time.perf_counter() - t0:.1f}s")
    feats = (cohort.num_features, 256, 64, 1)
    wp = dict(prune=True, prune_rate=PRUNE_RATE, prune_total=PRUNE_TOTAL)
    lr_scbf = 0.05 / K_CLIENTS
    runs, taps = {}, {}
    for label, method, loops, lr, scbf, fed in (
            ("scbf", "scbf", K_LOOPS, lr_scbf, {}, {}),
            ("fedavg", "fedavg", 2, 0.05, {}, {}),
            ("scbfwp_reshape", "scbf", WP_LOOPS, lr_scbf,
             dict(wp, prune_impl="reshape"), {}),
            ("scbfwp_mask", "scbf", WP_LOOPS, lr_scbf,
             dict(wp, prune_impl="mask", prune_compact=True), {}),
            ("scbf_sequential", "scbf", K_LOOPS, lr_scbf, {},
             dict(engine="sequential")),
            ("fedavg_sequential", "fedavg", 1, 0.05, {},
             dict(engine="sequential")),
            ("scbfwp_reshape_sequential", "scbf", WP_LOOPS, lr_scbf,
             dict(wp, prune_impl="reshape"), dict(engine="sequential")),
            ("scbfwp_mask_sequential", "scbf", WP_LOOPS, lr_scbf,
             dict(wp, prune_impl="mask", prune_compact=True),
             dict(engine="sequential")),
            ("scbf_dp", "scbf", K_LOOPS, lr_scbf, DP, {}),
            ("scbf_dirichlet", "scbf", DIR_LOOPS, lr_scbf, {}, DIRICHLET)):
        cfg = TrainConfig(learning_rate=lr, global_loops=loops,
                          local_epochs=2, local_batch_size=256, seed=0,
                          scbf=ScbfConfig(upload_rate=0.10,
                                          num_clients=K_CLIENTS, **scbf),
                          fed=FedConfig(**fed))
        with PruneTimer(torch) as timer, \
                RoundTap(masks=label in ("scbf", "scbf_sequential",
                                         "scbf_dp")) as tap:
            _reset_launches()
            res = run_federated(cohort, cfg, method=method,
                                mlp_features=feats, device="cuda")
            counts = _launch_counts()
        runs[label] = (res, counts, timer.seconds)
        taps[label] = tap
        _check_run(torch, label, res, counts, card, timer.seconds, tap,
                   cfg.fed.engine)
    compare_engines(torch, runs["scbf"][0], runs["scbf_sequential"][0],
                    taps["scbf"], taps["scbf_sequential"])
    check_dp_run(torch, runs["scbf_dp"][0], taps["scbf_dp"])
    check_dirichlet_run(runs["scbf_dirichlet"][0], taps["scbf_dirichlet"])
    return runs, cohort


def _check_run(torch, label, res, counts, card, prune_s, tap,
               engine: str) -> None:
    """Log every loop; hold the records, the weights and the launch counts
    to what the run must give.  A batched run launches K1, K2 and K3's
    count once a round that has participants, and K3's scatter once a
    round whose uploads hold a coo or bitmap weight leaf (the tap says
    which); a sequential run the same once a client pass; K4 once a
    validation batch of a prune step."""
    pruned = label.startswith("scbfwp")
    # prune steps run at loops 0 .. WP_STEPS-1; the mask run's compaction
    # follows the last step inside the same loop
    per_loop = [0.0] * len(res.records)
    if pruned:
        for i, s in enumerate(prune_s[:WP_STEPS]):
            per_loop[i] += s
        if label.startswith("scbfwp_mask"):
            per_loop[WP_STEPS - 1] += sum(prune_s[WP_STEPS:])
    for r, ps in zip(res.records, per_loop):
        log(f"[{label}] loop {r.loop} auc_roc={r.auc_roc:.4f} "
            f"auc_pr={r.auc_pr:.4f} upload_fraction={r.upload_fraction:.4f} "
            f"sparse_bytes={r.sparse_bytes} dense_bytes={r.dense_bytes} "
            f"hidden={'x'.join(map(str, r.hidden_sizes))} "
            f"clients={r.num_participants} epsilon={r.epsilon} "
            f"wall_s={r.wall_time:.3f} prune_s={ps:.3f} ({card})")
    log(f"[{label}] {engine} engine, kernel launches: {counts}")
    log(f"[{label}] weight-leaf codecs over {len(tap.units())} encoder "
        f"calls: {json.dumps(tap.mix())}")
    # DP noise of σ = 1 a revealed weight swamps the model: its AUC is
    # only held to be a probability, in [0, 1]; every other run's above 0.5
    for r in res.records:
        for v in (r.auc_roc, r.auc_pr):
            ok = 0.0 <= v <= 1.0 if label == "scbf_dp" else 0.5 < v <= 1.0
            if not (math.isfinite(v) and ok):
                raise AssertionError(f"{label} loop {r.loop}: AUC {v} out "
                                     f"of range")
        if r.sparse_bytes > r.dense_bytes:
            raise AssertionError(f"{label}: sparse > dense bytes")
    for layer in res.final_params:
        for v in layer.values():
            if v.device.type != "cuda" or not torch.isfinite(v).all():
                raise AssertionError(f"{label}: final params not finite "
                                     "on cuda")
    if label.startswith("fedavg"):
        want = dict.fromkeys(counts, 0)
    else:
        units = len(tap.units())
        passes = sum(r.num_participants for r in res.records)
        rounds = sum(1 for r in res.records if r.num_participants)
        if units != (rounds if engine == "batched" else passes):
            raise AssertionError(f"{label}: {units} encoder calls for "
                                 f"{rounds} rounds, {passes} passes")
        want = {"channel_norm": units, "select_mask": units,
                "select_compact_count": units,
                "select_compact_scatter": tap.scatter_units(),
                "apoz": WP_STEPS * VAL_BATCHES if pruned else 0}
        for r in res.records:
            if r.num_participants and not 0.0 < r.upload_fraction <= 1.0:
                raise AssertionError(f"{label} upload_fraction "
                                     f"{r.upload_fraction}")
    if counts != want:
        raise AssertionError(f"{label} kernel launches {counts}, want "
                             f"{want}")
    if pruned:
        final = res.records[-1].hidden_sizes
        if sum(final) != WP_HIDDEN or res.method != "scbfwp":
            raise AssertionError(f"{label}: final hidden {final} "
                                 f"({res.method}), want {WP_HIDDEN} in all")
        shapes = [tuple(l["w"].shape) for l in res.final_params]
        if shapes[1] != tuple(final):
            raise AssertionError(f"{label}: final weights {shapes} are not "
                                 f"the pruned model {final}")
        walls = [r.wall_time for r in res.records]
        log("prune: " + json.dumps({
            "run": label, "card": card,
            "loop_wall_s": walls, "prune_s": per_loop,
            "prune_share_while_pruning":
                sum(per_loop[1:WP_STEPS]) / sum(walls[1:WP_STEPS]),
            "wall_s_pruning_loops_1_to_6":
                sum(walls[1:WP_STEPS]) / (WP_STEPS - 1),
            "wall_s_after_budget": walls[-1]}))


def compare_engines(torch, batched, sequential, tap_b, tap_s) -> None:
    """SCBF on the batched engine against the sequential one, same draws
    (the run's generator).  The batched products are batched GEMMs, which
    may round otherwise than one GEMM a client: the final weights are held
    to 1e-5 and the AUCs to 1e-5 (a rounding of the last bits moves a
    prediction by far less).  The selection must come out the same: bytes
    and upload fractions equal.  The weight-mask entries that flip between
    the engines are counted and logged; bytes equal with a flip would need
    flips that cancel, and the count shows them."""
    import numpy as np

    from repro_torch.params import to_numpy

    flips, entries = [], 0
    mb, ms = tap_b.client_masks(), tap_s.client_masks()
    if len(mb) != len(ms):
        raise AssertionError(f"{len(mb)} batched client selections, "
                             f"{len(ms)} sequential")
    for a, b in zip(mb, ms):
        flips.append(int(sum(torch.count_nonzero(x["w"] != y["w"]).item()
                             for x, y in zip(a, b))))
        entries += sum(x["w"].numel() for x in a)
    for a, b in zip(batched.records, sequential.records):
        if a.upload_fraction != b.upload_fraction or \
                a.sparse_bytes != b.sparse_bytes or \
                abs(a.auc_roc - b.auc_roc) > 1e-5 or \
                abs(a.auc_pr - b.auc_pr) > 1e-5:
            raise AssertionError(f"batched vs sequential loop {a.loop}: "
                                 f"{a} != {b}")
    diff = max(float(np.max(np.abs(x[k] - y[k])))
               for x, y in zip(to_numpy(batched.final_params),
                               to_numpy(sequential.final_params))
               for k in x)
    if diff > 1e-5:
        raise AssertionError(f"batched vs sequential final weights differ "
                             f"by {diff}")
    log("engines: " + json.dumps({
        "batched_vs_sequential": "scbf, full width",
        "final_weights_max_abs_diff": diff,
        "sparse_bytes": [[a.sparse_bytes, b.sparse_bytes] for a, b in
                         zip(batched.records, sequential.records)],
        "upload_fraction": [[a.upload_fraction, b.upload_fraction]
                            for a, b in zip(batched.records,
                                            sequential.records)],
        "weight_mask_flips_per_client_pass": flips,
        "weight_mask_entries": entries,
        "loop_wall_s": [[a.wall_time, b.wall_time] for a, b in
                        zip(batched.records, sequential.records)]}))


def check_dp_run(torch, res, tap) -> None:
    """SCBF with DP: ε finite and rising loop on loop, and every payload
    carries its nonzero (noised) values on its reveal masks' coordinates —
    weights and biases — and nowhere else, on all of them but those whose
    noised value is exactly 0 (a normal draw of exactly 0 on a revealed
    zero gradient: the wire ships nonzeros), which must stay below 1e-5
    of the revealed entries."""
    from repro_torch.comm import wire

    eps = [r.epsilon for r in res.records]
    if not all(e is not None and math.isfinite(e) for e in eps) or \
            any(b <= a for a, b in zip(eps, eps[1:])) or \
            res.dp_delta is None:
        raise AssertionError(f"DP run: epsilon {eps}, delta {res.dp_delta}")
    payloads = [(p, st) for r in tap.rounds
                for p, st in zip(r["payloads"], r["stats"])]
    masks = tap.client_masks()
    revealed = zeros = 0
    for (payload, st), mask in zip(payloads, masks):
        for l, layer in enumerate(wire.decode(payload)):
            for k, t in layer.items():
                m = mask[l][k].cpu()
                if bool(torch.any((t != 0) & ~m)):
                    raise AssertionError(f"DP payload leaf {(l, k)} ships "
                                         f"a value off its reveal mask")
                zeros += int(torch.count_nonzero(m & (t == 0)))
        revealed += st.uploaded_params
    if len(masks) != len(payloads) or zeros > 1e-5 * revealed:
        raise AssertionError(f"DP payloads: {zeros} revealed entries of "
                             f"{revealed} ship no value")
    log(f"dp: epsilon {eps} (delta {res.dp_delta}); {len(payloads)} "
        f"payloads carry nonzero values only on their reveal masks, "
        f"{revealed - zeros} of {revealed} revealed entries noised and "
        f"{zeros} with a noised value of exactly 0")


def check_dirichlet_run(res, tap) -> None:
    """Dirichlet shards under sampling: the cohort is ragged (the masked
    loss), each round's participants fill a power-of-two bucket of slots,
    and only the participants' payloads leave the engine."""
    rows = [(r["participants"], r["slots"], len(r["payloads"]))
            for r in tap.rounds]
    if any(r["uniform"] is not False for r in tap.rounds):
        raise AssertionError("Dirichlet cohort ran the unweighted loss")
    for (p, b, n), rec in zip(rows, res.records):
        if n != p or rec.num_participants != p or b < p or \
                b != min(1 << max(p - 1, 0).bit_length(), K_CLIENTS):
            raise AssertionError(f"Dirichlet round: {p} participants, {b} "
                                 f"slots, {n} payloads")
    log("dirichlet: " + json.dumps({
        "participants_slots_payloads": rows, "masked_loss": True}))


def _device_events(prof) -> dict:
    """{kernel or copy name: (count, device us)} of a profiler window;
    the device-side marks of annotations (a schedule's ``ProfilerStep#``)
    span other work and are left out."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith("ProfilerStep")):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return by_name


# a substring of each kernel's name in a profiler trace, by launch counter
KERNEL_EVENTS = {"channel_norm": "channel_norms_kernel",
                 "select_mask": "select_mask_kernel",
                 "select_compact_count": "compact_count_kernel",
                 "select_compact_scatter": "compact_scatter_kernel",
                 "apoz": "apoz_leaves_kernel"}


def _kernel_events(by_name: dict) -> dict:
    """{launch counter: launches of its kernel} in a profiler window."""
    return {k: sum(n for name, (n, _) in by_name.items() if tag in name)
            for k, tag in KERNEL_EVENTS.items()}


def _window(by_name: dict, wall: float) -> dict:
    """Busy share, host-device copies and top kernels of a window."""
    busy_us = sum(us for _, us in by_name.values())
    copies = {kind: [sum(n for k, (n, _) in by_name.items() if tag in k),
                     sum(us for k, (_, us) in by_name.items() if tag in k)]
              for kind, tag in (("h2d", "HtoD"), ("d2h", "DtoH"))}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall if wall else None,
            "copies_count_us": copies,
            "top_by_device_us": [[k[:70], n, us] for k, (n, us) in top],
            "events": sum(n for n, _ in by_name.values()),
            "kernel_launches": _kernel_events(by_name)}


class ChunkTap:
    """Every fused chunk a run drives, while installed: for each call of
    the engine's chunk methods (``fused_scbf_chunk`` or
    ``fused_fedavg_chunk``, then ``emit_fused_payloads``) the kernel
    launches its wrappers made (a graph's replays are not among them),
    the graph replays, its device-synchronised wall and, for the
    emission, the payloads and stats.  Chunk ``guard`` (0-based) runs
    under ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside
    it raises.  Chunk ``profile`` is profiled, its replays and its
    emission in one torch.profiler window each, whose kernel events count
    what the replays launched."""

    def __init__(self, torch, guard=None, profile=None):
        from repro_torch.fed import engine as fe
        self.torch, self.cls = torch, fe.BatchedEngine
        self.names = ("fused_scbf_chunk", "fused_fedavg_chunk",
                      "emit_fused_payloads")
        self.saved = {n: getattr(self.cls, n) for n in self.names}
        self.guard, self.profile = guard, profile
        self.calls = {n: [] for n in self.names}

    def _wrap(self, name, fn):
        torch, tap = self.torch, self

        def wrapped(eng, *a, **k):
            from torch.profiler import ProfilerActivity, profile, schedule

            from repro_torch.fed import graphs
            i = len(tap.calls[name])
            torch.cuda.synchronize()
            before, replays = _launch_counts(), graphs.replays
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           schedule=schedule(wait=0, warmup=1, active=1)) \
                if i == tap.profile else None
            if prof is not None:
                # a warm-up step first: a window's first device activity
                # can go unrecorded when tracing has just started
                prof.start()
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                prof.step()
            t0 = time.perf_counter()
            if i == tap.guard and name != "emit_fused_payloads":
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(eng, *a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.stop()
            after = _launch_counts()
            rec = {"launches": {n: after[n] - before[n] for n in after},
                   "replays": graphs.replays - replays, "wall_s": wall,
                   "window": None if prof is None
                   else _window(_device_events(prof), wall)}
            if name == "emit_fused_payloads":
                rec["rounds"] = out
            tap.calls[name].append(rec)
            return out
        return wrapped

    def __enter__(self):
        for n, fn in self.saved.items():
            setattr(self.cls, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.cls, n, fn)

    def payloads(self) -> list:
        """Per (loop, participant) the emitted payloads, in order."""
        return [p for c in self.calls["emit_fused_payloads"]
                for payloads, _ in c["rounds"] for p in payloads]

    def stats(self) -> list:
        return [s for c in self.calls["emit_fused_payloads"]
                for _, stats in c["rounds"] for s in stats]


def _support_flips(torch, a, b) -> tuple:
    """(weight entries whose shipped support differs, weight entries) over
    two equal-length lists of payloads, leaf by leaf."""
    from repro_torch.comm import wire
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} payloads against {len(b)}")
    flips = entries = 0
    for pa, pb in zip(a, b):
        da, db = wire.decode(pa), wire.decode(pb)
        for x, y in zip(da, db):
            flips += int(torch.count_nonzero((x["w"] != 0) != (y["w"] != 0)))
            entries += x["w"].numel()
    return flips, entries


def _max_diff(a, b) -> float:
    import numpy as np

    from repro_torch.params import to_numpy
    return max(float(np.max(np.abs(x[k] - y[k])))
               for x, y in zip(to_numpy(a), to_numpy(b)) for k in x)


def _scatter_pairs(payloads) -> int:
    """1 if an upload has a coo or bitmap weight leaf that keeps an entry
    (the emission then launches K3's scatter), else 0."""
    return int(any(k == "w" and lp.codec != "dense" and lp.nnz
                   for p in payloads
                   for (_, k), lp in zip(p.keys, p.layers)))


def phase_fused(torch, cohort, card: str, runs: dict) -> dict:
    """The fused round loop at full width (``fuse_rounds`` = 2 on the
    batched engine): SCBF 4 loops beside the per-round run of the same 4
    loops (bytes and upload fractions equal, weights to 1e-5, support
    flips counted; one chunk under sync-debug "error"; launches and one
    capture asserted), FedAvg 2 loops against per-round (1e-5), SCBFwP
    mask 8 loops (hidden sizes the per-round run's, at most 2 captures),
    SCBF with DP 2 loops (ε the per-round run's, revealed entries
    noised); then a profile of one fused chunk, whose kernel events must
    show each replay launching K1 and K2 once, and of one per-round
    mask-mode loop.  Adds the fused runs to ``runs`` (their wrapper
    launches: warm-ups, emissions, K4) and returns the replays: each
    run's count and the profiled chunk's kernel events."""
    from repro_torch.config import FedConfig, ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.fed import graphs

    feats = (cohort.num_features, 256, 64, 1)
    wp = dict(prune=True, prune_rate=PRUNE_RATE, prune_total=PRUNE_TOTAL,
              prune_impl="mask", prune_compact=True)

    def cfg(method, loops, fuse, scbf=None):
        return TrainConfig(learning_rate=0.05 / K_CLIENTS
                           if method == "scbf" else 0.05,
                           global_loops=loops, local_epochs=2,
                           local_batch_size=256, seed=0,
                           scbf=ScbfConfig(upload_rate=0.10,
                                           num_clients=K_CLIENTS,
                                           **(scbf or {})),
                           fed=FedConfig(fuse_rounds=fuse))

    replays = {}

    def run(label, method, loops, fuse, scbf=None, tap=None):
        graphs.reset_captures()
        _reset_launches()
        res = run_federated(cohort, cfg(method, loops, fuse, scbf),
                            method=method, mlp_features=feats, device="cuda")
        counts = _launch_counts()
        runs[label] = (res, counts, [])
        replays[label] = graphs.replays
        for r in res.records:
            log(f"[{label}] loop {r.loop} auc_roc={r.auc_roc:.4f} "
                f"evaluated={r.evaluated} upload_fraction="
                f"{r.upload_fraction:.4f} sparse_bytes={r.sparse_bytes} "
                f"hidden={'x'.join(map(str, r.hidden_sizes))} "
                f"epsilon={r.epsilon} wall_s={r.wall_time:.4f} amortized="
                f"{r.wall_is_amortized} ({card})")
        log(f"[{label}] kernel launches {counts}, captures "
            f"{graphs.captures}, graph replays {graphs.replays}")
        for layer in res.final_params:
            for v in layer.values():
                if v.device.type != "cuda" or not torch.isfinite(v).all():
                    raise AssertionError(f"{label}: final params not "
                                         "finite on cuda")
        return res, counts, graphs.captures

    # --- SCBF: fused against per-round, one chunk sync-free ------------
    with RoundTap() as per_tap:
        per, _, _ = run("scbf_per_round_4", "scbf", FUSE_LOOPS, 1)
    with ChunkTap(torch, guard=1) as tap:
        fused, counts, caps = run("scbf_fused", "scbf", FUSE_LOOPS, FUSE)
    for a, b in zip(per.records, fused.records):
        if (a.sparse_bytes, a.upload_fraction, a.dense_bytes) != \
                (b.sparse_bytes, b.upload_fraction, b.dense_bytes):
            raise AssertionError(f"fused vs per-round loop {a.loop}: {a} != "
                                 f"{b}")
    if [r.evaluated for r in fused.records] != [False, True, False, True] \
            or not all(r.wall_is_amortized for r in fused.records):
        raise AssertionError("fused SCBF records: evaluated "
                             f"{[r.evaluated for r in fused.records]}")
    diff = _max_diff(per.final_params, fused.final_params)
    bitwise = all(torch.equal(x[k], y[k]) for x, y in
                  zip(per.final_params, fused.final_params) for k in x)
    if diff > 1e-5:
        raise AssertionError(f"fused vs per-round weights differ by {diff}")
    flips, entries = _support_flips(
        torch, [p for unit in per_tap.units() for p in unit], tap.payloads())
    none = dict.fromkeys(KERNEL_EVENTS, 0)
    replay = tap.calls["fused_scbf_chunk"][1]["launches"]
    chunk_replays = tap.calls["fused_scbf_chunk"][1]["replays"]
    emit = tap.calls["emit_fused_payloads"][1]["launches"]
    want_emit = {"channel_norm": 0, "select_mask": 0,
                 "select_compact_count": 1,
                 "select_compact_scatter": _scatter_pairs(
                     [p for rnd in tap.calls["emit_fused_payloads"][1][
                         "rounds"] for p in rnd[0]]),
                 "apoz": 0}
    # the capture's warm-up calls; the replays launch K1 and K2 outside
    # the wrappers (counted from the profiler below)
    want_run = {"channel_norm": graphs.WARMUP,
                "select_mask": graphs.WARMUP,
                "select_compact_count": FUSE_LOOPS // FUSE,
                "select_compact_scatter": sum(
                    _scatter_pairs([p for rnd in c["rounds"] for p in rnd[0]])
                    for c in tap.calls["emit_fused_payloads"]),
                "apoz": 0}
    if replay != none or chunk_replays != FUSE or emit != want_emit or \
            counts != want_run or replays["scbf_fused"] != FUSE_LOOPS or \
            caps != 1:
        raise AssertionError(f"fused SCBF launches: chunk {replay} (want "
                             f"none) in {chunk_replays} replays (want "
                             f"{FUSE}), emission {emit} (want {want_emit}), "
                             f"run {counts} (want {want_run}) in "
                             f"{replays['scbf_fused']} replays (want "
                             f"{FUSE_LOOPS}), captures {caps}")
    log("fused: " + json.dumps({
        "run": "scbf, fuse_rounds=2, 4 loops, full width", "card": card,
        "sync_debug_error_chunk": 1, "captures": caps,
        "chunk_wrapper_launches": replay, "chunk_replays": chunk_replays,
        "emission_launches": emit, "run_wrapper_launches": counts,
        "run_replays": replays["scbf_fused"],
        "final_weights_max_abs_diff_vs_per_round": diff,
        "final_weights_bitwise": bitwise,
        "support_flips": flips, "weight_entries": entries,
        "loop_wall_s_fused": [r.wall_time for r in fused.records],
        "loop_wall_s_per_round": [r.wall_time for r in per.records],
        "chunk_wall_s": [c["wall_s"] for c in
                         tap.calls["fused_scbf_chunk"]],
        "emission_wall_s": [c["wall_s"] for c in
                            tap.calls["emit_fused_payloads"]]}))

    # --- FedAvg ---------------------------------------------------------
    fa_per = runs["fedavg"][0]                      # per round, 2 loops
    fa, _, fa_caps = run("fedavg_fused", "fedavg", 2, FUSE)
    fa_diff = _max_diff(fa_per.final_params, fa.final_params)
    if fa_diff > 1e-5 or fa_caps != 1:
        raise AssertionError(f"fused FedAvg: weights differ by {fa_diff}, "
                             f"captures {fa_caps}")
    log(f"fused: fedavg 2 loops, weights max abs diff vs per-round "
        f"{fa_diff:.3g}, bitwise "
        f"{all(torch.equal(x[k], y[k]) for x, y in zip(fa_per.final_params, fa.final_params) for k in x)}, "
        f"captures {fa_caps} ({card})")

    # --- SCBFwP mask ----------------------------------------------------
    mask, mask_counts, mask_caps = run("scbfwp_mask_fused", "scbf",
                                       WP_LOOPS, FUSE, wp)
    ref_mask = runs["scbfwp_mask"][0]
    hidden = [r.hidden_sizes for r in mask.records]
    if hidden != [r.hidden_sizes for r in ref_mask.records] or \
            mask_caps > 2 or mask_counts["apoz"] != WP_STEPS * VAL_BATCHES:
        raise AssertionError(f"fused SCBFwP mask: hidden {hidden}, captures "
                             f"{mask_caps}, launches {mask_counts}")
    log("fused: " + json.dumps({
        "run": "scbfwp mask, fuse_rounds=2, 8 loops", "card": card,
        "captures": mask_caps, "hidden": hidden,
        "sparse_bytes_equal_per_round": [
            a.sparse_bytes == b.sparse_bytes
            for a, b in zip(ref_mask.records, mask.records)],
        "final_weights_max_abs_diff_vs_per_round":
            _max_diff(ref_mask.final_params, mask.final_params),
        "loop_wall_s_fused": [r.wall_time for r in mask.records],
        "loop_wall_s_per_round": [r.wall_time for r in ref_mask.records],
        "launches": mask_counts}))

    # --- SCBF with DP ---------------------------------------------------
    with ChunkTap(torch) as dp_tap:
        dp, _, dp_caps = run("scbf_dp_fused", "scbf", K_LOOPS, FUSE, DP)
    ref_dp = runs["scbf_dp"][0]
    eps, want_eps = [r.epsilon for r in dp.records], \
        [r.epsilon for r in ref_dp.records]
    revealed = sum(s.uploaded_params for s in dp_tap.stats())
    shipped = sum(lp.nnz for p in dp_tap.payloads() for lp in p.layers)
    if eps != want_eps or revealed - shipped > 1e-5 * revealed or \
            dp_caps != 1:
        raise AssertionError(f"fused DP: epsilon {eps} (want {want_eps}), "
                             f"{revealed - shipped} of {revealed} revealed "
                             f"entries unshipped, captures {dp_caps}")
    log("fused: " + json.dumps({
        "run": "scbf + DP (sigma 1, clip 1), fuse_rounds=2, 2 loops",
        "card": card, "epsilon": eps, "revealed": revealed,
        "noised_and_shipped": shipped,
        "sparse_bytes_equal_per_round": [
            a.sparse_bytes == b.sparse_bytes
            for a, b in zip(ref_dp.records, dp.records)],
        "final_weights_max_abs_diff_vs_per_round":
            _max_diff(ref_dp.final_params, dp.final_params)}))

    # --- profile: one fused chunk, one per-round mask-mode loop ---------
    with ChunkTap(torch, profile=1) as prof_tap:
        run("scbf_fused_profiled", "scbf", FUSE_LOOPS, FUSE)
    runs.pop("scbf_fused_profiled")
    chunk = prof_tap.calls["fused_scbf_chunk"][1]
    emitted = prof_tap.calls["emit_fused_payloads"][1]
    # what the replays launched, from the trace: K1 and K2 once a replay
    # (a round), nothing through the wrappers; the emission's kernel
    # events are its wrappers' launches
    seen = chunk["window"]["kernel_launches"]
    want_seen = dict(none, channel_norm=chunk["replays"],
                     select_mask=chunk["replays"])
    if chunk["replays"] != FUSE or seen != want_seen or \
            chunk["launches"] != none or \
            emitted["window"]["kernel_launches"] != emitted["launches"]:
        raise AssertionError(
            f"profiled fused chunk: {chunk['replays']} replays (want "
            f"{FUSE}), kernel events {seen} (want {want_seen}), wrapper "
            f"launches {chunk['launches']} (want none); emission events "
            f"{emitted['window']['kernel_launches']} against its wrapper "
            f"launches {emitted['launches']}; emission trace "
            f"{emitted['window']['top_by_device_us']}")
    log("profile: " + json.dumps({
        "what": "one steady fused SCBF chunk (2 rounds, full width): the "
                "replays, then the emission",
        "card": card,
        "amortized_loop_wall_s_unprofiled": [r.wall_time for r in
                                             fused.records],
        "replays": chunk["window"], "emission": emitted["window"]}))
    mask_loop_profile(torch, cohort, card, cfg(
        "scbf", 1, 1, wp), feats)
    return {"measured_by": "torch.profiler kernel events of one steady "
                           "fused SCBF chunk",
            "chunk_replays": chunk["replays"], "chunk_kernel_launches": seen,
            "replays_by_run": replays}


def mask_loop_profile(torch, cohort, card, cfg, feats) -> None:
    """One per-round mask-mode SCBFwP loop (loop 0: a round of masked
    training, effective-geometry uploads, their expansion and the server
    apply, then a prune step): host seconds of its parts and the device's
    busy share, to say where the mask-mode excess over SCBF goes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.comm import wire
    from repro_torch.core import pruning
    from repro_torch.core.scbf import run_federated
    from repro_torch.fed import engine as fe

    parts = {}
    targets = [(pruning, "expand_payloads"), (wire, "apply_payloads"),
               (wire, "encode_round"), (pruning.Pruner, "step"),
               (fe.BatchedEngine, "_pass")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]

    def timed(name, fn):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
            return out
        return inner

    for obj, name, fn in saved:
        setattr(obj, name, timed(name, fn))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run_federated(cohort, cfg, mlp_features=feats,
                                device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    log("profile: " + json.dumps({
        "what": "one per-round SCBFwP mask loop (masked round + prune "
                "step), evaluation included, host parts synchronised",
        "card": card, "round_wall_s": res.records[0].wall_time,
        "host_s": parts, **_window(_device_events(prof), wall)}))


def phase_big_round(torch, cohort, card: str) -> None:
    """C1 on the card: one batched round of 256 participants at the
    paper's widths (the cohort split 256 ways, batch 32), past the 2^22
    words of partials K1's library once held: one launch each of K1, K2
    and K3's count, and slot s of the round's selection and encoding
    bitwise the one-slot calls on slot s."""
    import numpy as np

    from repro_torch.comm import wire
    from repro_torch.config import ScbfConfig
    from repro_torch.core import selection
    from repro_torch.core.client import client_delta
    from repro_torch.data.medical import federated_split
    from repro_torch.fed.engine import BatchedEngine, _train_slots
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.models.mlp_net import init_mlp

    shards = federated_split(cohort.x_train, cohort.y_train, BIG_ROUND,
                             seed=0)
    eng = BatchedEngine(shards, BIG_BATCH, 1, "cuda")
    feats = (cohort.num_features, 256, 64, 1)
    params = init_mlp(feats, torch.Generator().manual_seed(3), "cuda")
    gen = torch.Generator().manual_seed(4)
    part = np.arange(BIG_ROUND)
    perms = [[torch.randperm(eng.perm_length(k), generator=gen)]
             for k in part]
    cfg = ScbfConfig(upload_rate=0.10)
    shapes = [(BIG_ROUND, a, b) for a, b in zip(feats[:-1], feats[1:])]
    words = cn.workspace_words([torch.empty(s, device="meta")
                                for s in shapes])
    _reset_launches()
    t0 = time.perf_counter()
    payloads, stats = eng.scbf_round(params, part, 0.01, perms, cfg,
                                     generator=torch.Generator()
                                     .manual_seed(5))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    want = {"channel_norm": 1, "select_mask": 1, "select_compact_count": 1,
            "select_compact_scatter": _scatter_pairs(payloads), "apoz": 0}
    if counts != want or len(payloads) != BIG_ROUND or words <= 1 << 22:
        raise AssertionError(f"C1 round: launches {counts} (want {want}), "
                             f"{len(payloads)} payloads, {words} words")
    # the same round's delta, then its selection a slot at a time
    rows, valid, pm = eng._slot_inputs(part, perms, BIG_ROUND)
    g = client_delta(*_train_slots(params, eng.cohort, rows, valid, 0.01,
                                   pm, batch_size=BIG_BATCH, epochs=1))
    masked, masks, _, ops = selection.select_gradients(
        g, 0.10, generator=torch.Generator().manual_seed(5))
    stacked = wire.encode_round(masked, ops, BIG_ROUND)
    slot_gen = torch.Generator().manual_seed(5)
    same = 0
    for s in range(BIG_ROUND):
        one = tuple({k: v[s] for k, v in layer.items()} for layer in g)
        m1, k1, _, o1 = selection.select_gradients(one, 0.10,
                                                   generator=slot_gen)
        p1 = wire.encode_selected(m1, o1)
        ok = all(torch.equal(m1[l][k], masked[l][k][s])
                 for l in range(len(m1)) for k in m1[l]) and \
            p1.nbytes == stacked[s].nbytes and all(
                np.array_equal(a.values, b.values)
                for a, b in zip(p1.layers, stacked[s].layers))
        same += int(ok)
    if same != BIG_ROUND:
        raise AssertionError(f"C1: {BIG_ROUND - same} of {BIG_ROUND} slots "
                             "differ from their one-slot calls")
    round_same = all(a.nbytes == b.nbytes and all(
        np.array_equal(x.values, y.values)
        for x, y in zip(a.layers, b.layers))
        for a, b in zip(payloads, stacked))
    log("c1: " + json.dumps({
        "round": f"{BIG_ROUND} participants, widths {feats}, batch "
                 f"{BIG_BATCH}", "card": card,
        "channel_norm_workspace_words": words, "old_scratch_words": 1 << 22,
        "launches": counts, "round_wall_s": wall,
        "slots_bitwise_their_one_slot_calls": same,
        "engine_round_equals_stacked_pass": round_same,
        "upload_fraction_mean": float(np.mean([s.upload_fraction
                                               for s in stats]))}))


def phase_profile(torch, cohort, card: str) -> None:
    """Where one loop's time goes: torch.profiler over one full-width
    loop (evaluation included) of SCBF on the batched engine, SCBF on the
    sequential engine and SCBFwP (reshape, one prune step, batched):
    device busy share, host-device copies and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import FedConfig, ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated

    feats = (cohort.num_features, 256, 64, 1)
    for what, scbf, engine in (
            ("SCBF, batched engine", {}, "batched"),
            ("SCBF, sequential engine", {}, "sequential"),
            ("SCBFwP (reshape, one prune step), batched engine",
             dict(prune=True, prune_rate=PRUNE_RATE,
                  prune_total=PRUNE_TOTAL), "batched")):
        cfg = TrainConfig(learning_rate=0.05 / K_CLIENTS, global_loops=1,
                          local_epochs=2, local_batch_size=256, seed=0,
                          scbf=ScbfConfig(upload_rate=0.10,
                                          num_clients=K_CLIENTS, **scbf),
                          fed=FedConfig(engine=engine))
        run_federated(cohort, cfg, mlp_features=feats, device="cuda")  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run_federated(cohort, cfg, mlp_features=feats,
                                device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if not by_name:
            log("profile: device time not measured (the profiler recorded "
                "no CUDA events)")
            return
        busy_us = sum(us for _, us in by_name.values())
        copies = {kind: [sum(n for k, (n, _) in by_name.items() if tag in k),
                         sum(us for k, (_, us) in by_name.items()
                             if tag in k)]
                  for kind, tag in (("h2d", "HtoD"), ("d2h", "DtoH"))}
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        ours = {k: v for k, v in by_name.items()
                if any(s in k for s in ("channel_norms_kernel",
                                        "select_mask_kernel",
                                        "compact_count_kernel",
                                        "compact_scatter_kernel",
                                        "apoz_leaves_kernel", "Memset"))}
        log("profile: " + json.dumps({
            "what": f"one full-width {what} loop + evaluation",
            "card": card, "wall_s": wall,
            "round_wall_s": res.records[0].wall_time,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "copies_count_us": copies,
            "kernels": {k: {"launches": n, "device_us": us,
                            "us_per_launch": us / n}
                        for k, (n, us) in ours.items()},
            "top_by_device_us": [[k[:80], n, us] for k, (n, us) in top]}))


def phase_agreement(torch):
    """cuda run == cpu run of the port on one small input, same draws, on
    the batched engine: SCBF, SCBF with DP (normals injected) and SCBFwP
    in mask mode with compaction, per round and fused (captured rounds on
    cuda, eager on the CPU); and SCBFwP in mask mode with compaction on
    the sequential engine."""
    import numpy as np

    from repro_torch.config import FedConfig, ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import federated_split, generate_cohort
    from repro_torch.models.mlp_net import init_mlp
    from repro_torch.params import to_numpy

    feats, k, loops = (64, 32, 16, 1), 3, 3
    cohort = generate_cohort(num_admissions=1500, num_medicines=64, seed=0)
    sizes = [len(y) for _, y in federated_split(cohort.x_train,
                                                cohort.y_train, k, seed=0)]
    init = to_numpy(init_mlp(feats, torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(2)
    table = {(l, c, 0): rng.permutation(sizes[c])
             for l in range(loops) for c in range(k)}
    def normals(loop, i, shapes):
        r = np.random.default_rng(1000 * loop + i)
        return [r.standard_normal(s).astype(np.float32) for s in shapes]

    wp_mask = dict(prune=True, prune_rate=0.25, prune_total=0.4,
                   prune_impl="mask", prune_compact=True)
    for label, scbf, engine, fuse in (
            ("scbf", {}, "batched", 1), ("scbf_dp", DP, "batched", 1),
            ("scbfwp_mask", wp_mask, "batched", 1),
            ("scbfwp_mask_sequential", wp_mask, "sequential", 1),
            ("scbf_dp_fused", DP, "batched", loops),
            ("scbfwp_mask_fused", wp_mask, "batched", 2)):
        cfg = TrainConfig(learning_rate=0.05 / k, global_loops=loops,
                          local_batch_size=64, seed=0,
                          scbf=ScbfConfig(num_clients=k, **scbf),
                          fed=FedConfig(engine=engine, fuse_rounds=fuse))
        out = {}
        for dev in ("cuda", "cpu"):
            out[dev] = run_federated(cohort, cfg, method="scbf",
                                     mlp_features=feats, device=dev,
                                     init_params=init,
                                     perms=lambda l, c, e: table[(l, c, e)],
                                     dp_noise=normals)
        same_bytes = all(a.sparse_bytes == b.sparse_bytes for a, b in
                         zip(out["cuda"].records, out["cpu"].records))
        for a, b in zip(out["cuda"].records, out["cpu"].records):
            if abs(a.auc_roc - b.auc_roc) > 1e-3 or \
                    abs(a.auc_pr - b.auc_pr) > 1e-3 or \
                    abs(a.upload_fraction - b.upload_fraction) > 1e-2 or \
                    a.hidden_sizes != b.hidden_sizes:
                raise AssertionError(f"{label} cuda vs cpu loop {a.loop}: "
                                     f"{a} != {b}")
        diff = max(float(np.max(np.abs(x[key] - y[key])))
                   for x, y in zip(to_numpy(out["cuda"].final_params),
                                   to_numpy(out["cpu"].final_params))
                   for key in x)
        if diff > 1e-4:
            raise AssertionError(f"{label} cuda vs cpu final params differ "
                                 f"by {diff}")
        log(f"cuda vs cpu ({label}, small input): final params max abs diff "
            f"{diff:.3g}, sparse bytes identical: {same_bytes}, hidden "
            f"{out['cuda'].records[-1].hidden_sizes}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"build: kernels built and loaded in {build.build_seconds():.1f}s")
    t0 = time.perf_counter()
    report = phase_kernels(torch)
    log(f"phase kernels: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    runs, cohort = phase_main_path(torch, card)
    log(f"phase main path: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    replayed = phase_fused(torch, cohort, card, runs)
    log(f"phase fused: {time.perf_counter() - t0:.1f}s")
    for name, phase, args in (
            ("c1 round", phase_big_round, (torch, cohort, card)),
            ("profile", phase_profile, (torch, cohort, card)),
            ("agreement", phase_agreement, (torch,))):
        t0 = time.perf_counter()
        phase(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
    kinds = {"select_compact": ("select_compact_count",
                                "select_compact_scatter")}
    for r in report:
        by_run = {label: {k: counts[k] for k in kinds.get(r["name"],
                                                         (r["name"],))}
                  for label, (_, counts, _) in runs.items()}
        r["launches"] = sum(sum(c.values()) for c in by_run.values())
        r["launches_by_run"] = by_run
        # the fused runs' graph replays, apart from the wrapper counts
        r["graph_replay_launches"] = {
            "measured_by": replayed["measured_by"],
            "chunk_replays": replayed["chunk_replays"],
            "chunk_launches": sum(replayed["chunk_kernel_launches"][k]
                                  for k in kinds.get(r["name"],
                                                     (r["name"],))),
            "replays_by_run": replayed["replays_by_run"]}
        log("kernel timing: " + json.dumps(
            {"kernel": r["name"], "kernel_ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_us": r["bound_ms"] * 1e3,
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "launches": r["launches"],
             "graph_replay_launches": r["graph_replay_launches"],
             "shape": r["shape"],
             "card": card, **{k: v for k, v in r.items() if k in (
                 "ms_single_leaf", "device_us", "device_us_l2_warm",
                 "device_us_single_leaf",
                 "encoder", "memset_us", "memset_us_single_leaf", "slots",
                 "pass")}}))
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
