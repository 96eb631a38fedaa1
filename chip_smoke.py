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
   rtol 1e-5 / atol 1e-6 and bitwise equal across two launches;
   select_mask bitwise (values, mask, count) and select_compact bitwise
   (idx, vals, count) over several thresholds, an exact tie, rest in
   {0, 0.37}, -inf scores, drop_zeros on and off and a capacity below the
   count; the same for leaf tables (K2 one launch, K3 one count and one
   scatter launch over mixed shapes, capacities at size, half the count
   and the count); apoz bitwise at the SCBFwP path's shapes with an
   all-zero column, -0.0 and NaN.  Then times kernel and plain version
   (and apoz's library call) at the main path's shapes: K2 and K3 a
   client pass at a time, as one table and as single-leaf calls, K3 also
   on the encoder's count-first route, each with its device time from
   the profiler.
4. main path at full width — the synthetic cohort (30,760 × 2,917),
   MLP 2917-256-64-1, 5 IID clients, 2 local epochs, batch 256, upload
   rate 0.10, through ``repro_torch.core.scbf.run_federated`` on cuda:
   2 SCBF loops, 1 FedAvg loop, then 8 loops each of SCBFwP reshape and
   SCBFwP mask with compaction (prune rate 0.10, total 0.47: 150 of the
   320 hidden neurons go in 7 steps).  The launch counts are set to 0
   before each run and read after it: on every SCBF run K1 launches
   loops × clients × 3 times, K2 and K3's count loops × clients times,
   K3's scatter once a client pass with a coo or bitmap weight leaf (the
   run's codec mix is logged), K4 prune steps × 2 validation batches × 2
   hidden layers.
5. profile — torch.profiler over one more full-width SCBF loop: the
   device's busy share and the kernels that take its time.
6. small-input agreement — SCBF and SCBFwP (mask, compacted) on cuda
   and on the CPU (whose plain path the CPU tests hold against the JAX
   reference) from the same initial weights and permutations.
7. the card line, the kernel report line and the final ok line.
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
K_LOOPS, K_CLIENTS, LAYERS = 2, 5, 3
WP_LOOPS, PRUNE_RATE, PRUNE_TOTAL = 8, 0.10, 0.47
WP_STEPS, WP_HIDDEN = 7, 170          # 320 hidden neurons, 150 pruned
VAL_BATCHES, HIDDEN_LAYERS = 2, 2


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


def check_apoz(torch, gen) -> float:
    """K4 bitwise against its plain version; its max abs error (0)."""
    from repro_torch.kernels import apoz as az

    checks = 0
    for shape in APOZ_SHAPES + [(33, 257), (7, 9), (130, 3)]:
        a = torch.relu(torch.randn(shape, generator=gen)).cuda()
        a[0] = -0.0                     # -0.0 counts as a zero
        a[1, ::2] = float("nan")        # NaN does not
        a[:, shape[1] // 2] = 0.0       # an all-zero column
        got, want = az.apoz_counts(a), az.apoz_counts_plain(a)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or \
                int(got[shape[1] // 2]) != shape[0]:
            raise AssertionError(f"apoz_counts differs from plain at "
                                 f"{shape}")
        checks += 1
    log(f"kernels vs plain: apoz {checks} cases bitwise")
    return 0.0


def device_us(torch, fn, names, iters: int = 50):
    """Device microseconds per call of ``fn`` spent in the kernels whose
    names hold one of ``names``, from torch.profiler over ``iters`` calls;
    None if the profiler records no CUDA event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    return sum(e.time_range.elapsed_us() for e in events
               if any(s in e.name for s in names)) / iters


def time_kernels(torch, gen, errs: dict) -> list:
    """Kernel, plain version and library call timed in turns at the main
    path's shapes; the report rows (launches filled in later).  K2 and K3
    are timed a client pass at a time (one leaf a weight matrix, fp32,
    threshold at the 0.9 quantile of the pair sums): K2 as one table
    launch and as three single-leaf calls; K3 at capacity M*N with
    drop_zeros as one table (count + scatter launch) and as three
    single-leaf calls (PR 12's timing), and on the encoder's route:
    count, the counts read on the host, scatter of the coo and bitmap
    leaves at their counts."""
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
        p, k = in_turns(lambda: cn.channel_norms_plain(g),
                        lambda: cn.channel_norms(g))
        t["channel_norm"]["plain"] += p
        t["channel_norm"]["kernel"] += k
        nbytes["channel_norm"] += 4 * m * n + 4 * (m + n)
        flops["channel_norm"] += 3 * m * n
        nbytes["select_mask"] += 4 * m * n + 4 * (m + n) + 8 + 4 * m * n \
            + m * n + 4
        flops["select_mask"] += 3 * m * n
        nbytes["select_compact"] += 4 * m * n + 4 * (m + n) + 8 \
            + 8 * m * n + 4
        flops["select_compact"] += 4 * m * n
    sizes = [leaf[0].numel() for leaf in leaves]
    nnz = sm.compact_count(leaves, drop_zeros=True).counts.tolist()
    sparse = [k for k, (c, size) in enumerate(zip(nnz, sizes))
              if c and cheapest_bytes(c, size)[0] != "dense"]

    def compact_table():
        sm.compact_scatter(sm.compact_count(leaves, drop_zeros=True), sizes)

    def compact_encoder():
        cc = sm.compact_count(leaves, drop_zeros=True)
        counts = cc.counts.tolist()
        sm.compact_scatter(cc, [counts[k] for k in sparse], sparse)

    routes = {
        "select_mask": (
            lambda: [sm.select_mask_plain(*leaf) for leaf in leaves],
            lambda: sm.select_mask_leaves(leaves),
            lambda: [sm.select_mask(*leaf) for leaf in leaves],
            ("select_mask_kernel",)),
        "select_compact": (
            lambda: [sm.select_compact_plain(*leaf, leaf[0].numel(), True)
                     for leaf in leaves],
            compact_table,
            lambda: [sm.select_compact(*leaf, capacity=leaf[0].numel(),
                                       drop_zeros=True) for leaf in leaves],
            ("compact_",)),
    }
    extra = {}
    for name, (plain, table, single, names) in routes.items():
        p1, k1, s1, s2, k2, p2 = in_turns(plain, table, single, single,
                                          table, plain)
        t[name]["plain"] = (p1 + p2) / 2
        t[name]["kernel"] = (k1 + k2) / 2
        extra[name] = {"ms_single_leaf": (s1 + s2) / 2,
                       "device_us": device_us(torch, table, names),
                       "device_us_single_leaf": device_us(torch, single,
                                                          names)}
    enc_bytes = sum(4 * m * n + 4 * (m + n) + 12 for m, n in MAIN_SHAPES) \
        + sum(8 * nnz[k] for k in sparse)
    enc_bound, enc_by = bound_ms(enc_bytes, flops["select_compact"])
    extra["select_compact"]["encoder"] = {
        "ms": cuda_ms(compact_encoder),
        "device_us": device_us(torch, compact_encoder, ("compact_",)),
        "bound_us": enc_bound * 1e3, "bound_by": enc_by,
        "nnz": nnz, "scattered_leaves": sparse}
    # one SCBFwP prune step: 2 validation batches x 2 hidden layers
    for b, n in APOZ_SHAPES:
        a = torch.relu(torch.randn((b, n), generator=gen)).cuda()
        p, k = in_turns(lambda: az.apoz_counts_plain(a),
                        lambda: az.apoz_counts(a))
        t["apoz"]["plain"] += p
        t["apoz"]["kernel"] += k
        # the library's count of nonzeros per column: the complement of
        # the zero count, in one call
        t["apoz"]["library"] += cuda_ms(
            lambda: torch.count_nonzero(a, dim=0))
        nbytes["apoz"] += 4 * b * n + 4 * n
        flops["apoz"] += b * n
    main_txt = "+".join(f"{m}x{n}" for m, n in MAIN_SHAPES) + " fp32"
    apoz_txt = "+".join(f"{b}x{n}" for b, n in APOZ_SHAPES) + " fp32"
    meta = {
        "channel_norm": ("src/repro/kernels/channel_norm.py:48", main_txt,
                         None),
        "select_mask": ("src/repro/kernels/select_mask.py:123",
                        main_txt + ", one table launch a pass", None),
        # no one PyTorch call compacts by a pairwise score test in order
        "select_compact": ("src/repro/kernels/select_mask.py:78",
                           main_txt + ", capacity M*N, one table a pass "
                           "(count + scatter launch)", None),
        "apoz": ("src/repro/kernels/apoz.py:46", apoz_txt,
                 t["apoz"]["library"]),
    }
    report = []
    for name, (replaces, shape_txt, library) in meta.items():
        bound, by = bound_ms(nbytes[name], flops[name])
        report.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[name], "ms": t[name]["kernel"],
            "plain_ms": t[name]["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": library, "shape": shape_txt,
            **extra.get(name, {})})
    return report


def phase_kernels(torch) -> list:
    gen = torch.Generator().manual_seed(0)
    errs = {}
    errs["channel_norm"], errs["select_mask"] = \
        check_channel_norm_and_select_mask(torch, gen)
    errs["select_compact"] = check_select_compact(torch, gen)
    check_leaf_tables(torch, gen)
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


class CodecTally:
    """The codecs the upload encoder picks for the weight leaves, one
    tuple a client pass, while installed."""

    def __init__(self):
        from repro_torch.comm import wire
        self.wire, self.saved, self.passes = wire, wire.encode_selected, []

    def _encode(self, masked, operands):
        payload = self.saved(masked, operands)
        self.passes.append(tuple(
            (lp.codec, lp.nnz) for (_, k), lp in
            zip(payload.keys, payload.layers) if k == "w"))
        return payload

    def __enter__(self):
        self.wire.encode_selected = self._encode
        return self

    def __exit__(self, *exc):
        self.wire.encode_selected = self.saved

    def mix(self) -> dict:
        """{layer: {codec: passes}} over the weight leaves."""
        out = {}
        for leaves in self.passes:
            for l, (codec, _) in enumerate(leaves):
                per = out.setdefault(f"w{l}", {})
                per[codec] = per.get(codec, 0) + 1
        return out

    def scatter_passes(self) -> int:
        """Passes with a coo or bitmap weight leaf that keeps an entry:
        the passes whose encoder launches the scatter."""
        return sum(any(c != "dense" and nnz for c, nnz in leaves)
                   for leaves in self.passes)


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
    from repro_torch.config import ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import generate_cohort

    t0 = time.perf_counter()
    cohort = generate_cohort()
    log(f"cohort {cohort.x_train.shape[0]}+{cohort.x_val.shape[0]}+"
        f"{cohort.x_test.shape[0]} x {cohort.num_features} generated in "
        f"{time.perf_counter() - t0:.1f}s")
    feats = (cohort.num_features, 256, 64, 1)
    wp = dict(prune=True, prune_rate=PRUNE_RATE, prune_total=PRUNE_TOTAL)
    runs = {}
    for label, method, loops, lr, scbf in (
            ("scbf", "scbf", K_LOOPS, 0.05 / K_CLIENTS, {}),
            ("fedavg", "fedavg", 1, 0.05, {}),
            ("scbfwp_reshape", "scbf", WP_LOOPS, 0.05 / K_CLIENTS,
             dict(wp, prune_impl="reshape")),
            ("scbfwp_mask", "scbf", WP_LOOPS, 0.05 / K_CLIENTS,
             dict(wp, prune_impl="mask", prune_compact=True))):
        cfg = TrainConfig(learning_rate=lr, global_loops=loops,
                          local_epochs=2, local_batch_size=256, seed=0,
                          scbf=ScbfConfig(upload_rate=0.10,
                                          num_clients=K_CLIENTS, **scbf))
        with PruneTimer(torch) as timer, CodecTally() as codecs:
            _reset_launches()
            res = run_federated(cohort, cfg, method=method,
                                mlp_features=feats, device="cuda")
            counts = _launch_counts()
        runs[label] = (res, counts, timer.seconds)
        _check_run(torch, label, res, counts, card, timer.seconds, codecs)
    return runs, cohort


def _check_run(torch, label, res, counts, card, prune_s, codecs) -> None:
    """Log every loop; hold the records, the weights and the launch counts
    to what the run must give: K1 three launches a client pass, K2 one,
    K3 one count launch a pass and one scatter launch a pass that has a
    coo or bitmap weight leaf (the codec tally says which)."""
    pruned = label.startswith("scbfwp")
    # prune steps run at loops 0 .. WP_STEPS-1; the mask run's compaction
    # follows the last step inside the same loop
    per_loop = [0.0] * len(res.records)
    if pruned:
        for i, s in enumerate(prune_s[:WP_STEPS]):
            per_loop[i] += s
        if label == "scbfwp_mask":
            per_loop[WP_STEPS - 1] += sum(prune_s[WP_STEPS:])
    for r, ps in zip(res.records, per_loop):
        log(f"[{label}] loop {r.loop} auc_roc={r.auc_roc:.4f} "
            f"auc_pr={r.auc_pr:.4f} upload_fraction={r.upload_fraction:.4f} "
            f"sparse_bytes={r.sparse_bytes} dense_bytes={r.dense_bytes} "
            f"hidden={'x'.join(map(str, r.hidden_sizes))} "
            f"wall_s={r.wall_time:.3f} prune_s={ps:.3f} ({card})")
    log(f"[{label}] kernel launches: {counts}")
    log(f"[{label}] weight-leaf codecs over {len(codecs.passes)} client "
        f"passes: {json.dumps(codecs.mix())}")
    for r in res.records:
        for v in (r.auc_roc, r.auc_pr):
            if not (math.isfinite(v) and 0.5 < v <= 1.0):
                raise AssertionError(f"{label} loop {r.loop}: AUC {v} not "
                                     "in (0.5, 1]")
        if r.sparse_bytes > r.dense_bytes:
            raise AssertionError(f"{label}: sparse > dense bytes")
    for layer in res.final_params:
        for v in layer.values():
            if v.device.type != "cuda" or not torch.isfinite(v).all():
                raise AssertionError(f"{label}: final params not finite "
                                     "on cuda")
    passes = len(res.records) * K_CLIENTS
    if label == "fedavg":
        want = dict.fromkeys(counts, 0)
    else:
        if len(codecs.passes) != passes:
            raise AssertionError(f"{label}: {len(codecs.passes)} encoded "
                                 f"passes, want {passes}")
        want = {"channel_norm": passes * LAYERS, "select_mask": passes,
                "select_compact_count": passes,
                "select_compact_scatter": codecs.scatter_passes(),
                "apoz": WP_STEPS * VAL_BATCHES * HIDDEN_LAYERS if pruned
                else 0}
        for r in res.records:
            if not 0.0 < r.upload_fraction < 1.0:
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


def phase_profile(torch, cohort, card: str) -> None:
    """Where one loop's time goes: torch.profiler over one full-width
    loop (evaluation included) of SCBF and of SCBFwP (reshape: one prune
    step), device busy share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated

    feats = (cohort.num_features, 256, 64, 1)
    for what, scbf in (("SCBF", {}),
                       ("SCBFwP (reshape, one prune step)",
                        dict(prune=True, prune_rate=PRUNE_RATE,
                             prune_total=PRUNE_TOTAL))):
        cfg = TrainConfig(learning_rate=0.05 / K_CLIENTS, global_loops=1,
                          local_epochs=2, local_batch_size=256, seed=0,
                          scbf=ScbfConfig(upload_rate=0.10,
                                          num_clients=K_CLIENTS, **scbf))
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
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        ours = {k: v for k, v in by_name.items()
                if any(s in k for s in ("partials_kernel", "finish_kernel",
                                        "select_mask_kernel",
                                        "compact_count_kernel",
                                        "compact_scatter_kernel",
                                        "apoz_counts_kernel"))}
        log("profile: " + json.dumps({
            "what": f"one full-width {what} loop + evaluation",
            "card": card, "wall_s": wall,
            "round_wall_s": res.records[0].wall_time,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernels": {k: {"launches": n, "device_us": us,
                            "us_per_launch": us / n}
                        for k, (n, us) in ours.items()},
            "top_by_device_us": [[k[:80], n, us] for k, (n, us) in top]}))


def phase_agreement(torch):
    """cuda run == cpu run of the port on one small input, same draws:
    SCBF, and SCBFwP in mask mode with compaction."""
    import numpy as np

    from repro_torch.config import ScbfConfig, TrainConfig
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
    for label, scbf in (("scbf", {}),
                        ("scbfwp_mask", dict(prune=True, prune_rate=0.25,
                                             prune_total=0.4,
                                             prune_impl="mask"))):
        cfg = TrainConfig(learning_rate=0.05 / k, global_loops=loops,
                          local_batch_size=64, seed=0,
                          scbf=ScbfConfig(num_clients=k, **scbf))
        out = {}
        for dev in ("cuda", "cpu"):
            out[dev] = run_federated(cohort, cfg, method="scbf",
                                     mlp_features=feats, device=dev,
                                     init_params=init,
                                     perms=lambda l, c, e: table[(l, c, e)])
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
    report = phase_kernels(torch)
    runs, cohort = phase_main_path(torch, card)
    phase_profile(torch, cohort, card)
    phase_agreement(torch)
    kinds = {"select_compact": ("select_compact_count",
                                "select_compact_scatter")}
    for r in report:
        by_run = {label: {k: counts[k] for k in kinds.get(r["name"],
                                                         (r["name"],))}
                  for label, (_, counts, _) in runs.items()}
        r["launches"] = sum(sum(c.values()) for c in by_run.values())
        r["launches_by_run"] = by_run
        log("kernel timing: " + json.dumps(
            {"kernel": r["name"], "kernel_ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_us": r["bound_ms"] * 1e3,
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "launches": r["launches"], "shape": r["shape"],
             "card": card, **{k: v for k, v in r.items() if k in (
                 "ms_single_leaf", "device_us", "device_us_single_leaf",
                 "encoder")}}))
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
