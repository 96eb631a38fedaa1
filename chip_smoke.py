#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on past
its own failure:

1. device — needs a CUDA device; prints the card's name and power limit
   (nvidia-smi) and the torch/CUDA versions.
2. build — compiles the Hopper kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc (one process per source, in parallel).
3. kernels vs plain — each kernel against its plain PyTorch version on
   the card, fp32 and bf16, at the main path's shapes and ragged ones:
   channel_norm to rtol 1e-5 / atol 1e-6 and bitwise equal across two
   launches; select_mask bitwise (values, mask, count) over several
   thresholds, an exact tie, rest in {0, 0.37} and -inf scores.  Then
   times kernel and plain version at the main path's shapes.
4. main path at full width — the synthetic cohort (30,760 × 2,917),
   MLP 2917-256-64-1, 5 IID clients, 2 local epochs, batch 256,
   upload rate 0.10: 2 SCBF loops, then 1 FedAvg loop, through
   ``repro_torch.core.scbf.run_federated`` on cuda.  Each kernel's
   launch count over the SCBF run must be loops × clients × 3 = 30.
5. profile — torch.profiler over one more full-width SCBF loop: the
   device's busy share and the kernels that take its time.
6. small-input agreement — the same run on cuda and on the CPU (whose
   plain path the CPU tests hold against the JAX reference) from the
   same initial weights and permutations.
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
K_LOOPS, K_CLIENTS, LAYERS = 2, 5, 3


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


def in_turns(plain, kernel) -> tuple:
    """(plain_ms, kernel_ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), \
        cuda_ms(plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(torch):
    from repro_torch.core.channels import quantile
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    gen = torch.Generator().manual_seed(0)
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
            # -inf scores on some rows and columns (pruned neurons)
            srow, scol = prow.clone(), pcol.clone()
            srow[::7] = float("-inf")
            if shape[1] > 1:
                scol[1::5] = float("-inf")
            pairs = (srow[:, None] + scol[None, :]).reshape(-1)
            finite = pairs[torch.isfinite(pairs)]
            thrs = [quantile(finite, q) for q in (0.1, 0.5, 0.9)]
            thrs.append(finite[finite.numel() // 2].clone())   # exact tie
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

    # timing at the main path's shapes (fp32): one client's pass is one
    # call per weight matrix
    t_cn = {"plain": 0.0, "kernel": 0.0}
    t_sm = {"plain": 0.0, "kernel": 0.0}
    b_cn = b_sm = f_cn = f_sm = 0.0
    for m, n in MAIN_SHAPES:
        g = torch.randn((m, n), generator=gen).cuda()
        row, col = cn.channel_norms_plain(g)
        thr = quantile((row[:, None] + col[None, :]).reshape(-1), 0.9)
        rest = torch.tensor(0.0, device="cuda")
        p, k = in_turns(lambda: cn.channel_norms_plain(g),
                        lambda: cn.channel_norms(g))
        t_cn["plain"] += p
        t_cn["kernel"] += k
        p, k = in_turns(lambda: sm.select_mask_plain(g, row, col, thr, rest),
                        lambda: sm.select_mask(g, row, col, thr, rest))
        t_sm["plain"] += p
        t_sm["kernel"] += k
        b_cn += 4 * m * n + 4 * (m + n)
        f_cn += 3 * m * n
        b_sm += 4 * m * n + 4 * (m + n) + 8 + 4 * m * n + m * n + 4
        f_sm += 3 * m * n
    cn_bound, cn_by = bound_ms(b_cn, f_cn)
    sm_bound, sm_by = bound_ms(b_sm, f_sm)
    shape_txt = "+".join(f"{m}x{n}" for m, n in MAIN_SHAPES) + " fp32"
    report = [
        {"name": "channel_norm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/channel_norm.cu",
         "replaces": "src/repro/kernels/channel_norm.py:48",
         "launches": None, "max_abs_err": err_cn,
         "ms": t_cn["kernel"], "plain_ms": t_cn["plain"],
         "bound_ms": cn_bound, "bound_by": cn_by, "library_ms": None,
         "shape": shape_txt},
        {"name": "select_mask", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/select_mask.cu",
         "replaces": "src/repro/kernels/select_mask.py:123",
         "launches": None, "max_abs_err": err_sm,
         "ms": t_sm["kernel"], "plain_ms": t_sm["plain"],
         "bound_ms": sm_bound, "bound_by": sm_by, "library_ms": None,
         "shape": shape_txt},
    ]
    return report


def phase_main_path(torch, card: str):
    from repro_torch.config import ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import generate_cohort
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    t0 = time.perf_counter()
    cohort = generate_cohort()
    log(f"cohort {cohort.x_train.shape[0]}+{cohort.x_val.shape[0]}+"
        f"{cohort.x_test.shape[0]} x {cohort.num_features} generated in "
        f"{time.perf_counter() - t0:.1f}s")
    runs = {}
    for method, loops, lr in (("scbf", K_LOOPS, 0.05 / K_CLIENTS),
                              ("fedavg", 1, 0.05)):
        cfg = TrainConfig(learning_rate=lr, global_loops=loops,
                          local_epochs=2, local_batch_size=256, seed=0,
                          scbf=ScbfConfig(upload_rate=0.10,
                                          num_clients=K_CLIENTS))
        cn.reset_launches()
        sm.reset_launches()
        res = run_federated(cohort, cfg, method=method,
                            mlp_features=(cohort.num_features, 256, 64, 1),
                            device="cuda")
        counts = {"channel_norm": cn.launches, "select_mask": sm.launches}
        runs[method] = (res, counts)
        for r in res.records:
            log(f"[{method}] loop {r.loop} auc_roc={r.auc_roc:.4f} "
                f"auc_pr={r.auc_pr:.4f} upload_fraction="
                f"{r.upload_fraction:.4f} sparse_bytes={r.sparse_bytes} "
                f"dense_bytes={r.dense_bytes} wall_s={r.wall_time:.3f} "
                f"({card})")
        log(f"[{method}] kernel launches: {counts}")
        for r in res.records:
            for v in (r.auc_roc, r.auc_pr):
                if not (math.isfinite(v) and 0.5 < v <= 1.0):
                    raise AssertionError(f"{method} loop {r.loop}: AUC {v} "
                                         "not in (0.5, 1]")
            if r.sparse_bytes > r.dense_bytes:
                raise AssertionError(f"{method}: sparse > dense bytes")
        for layer in res.final_params:
            for v in layer.values():
                if v.device.type != "cuda" or not torch.isfinite(v).all():
                    raise AssertionError(f"{method}: final params not "
                                         "finite on cuda")
    scbf_res, scbf_counts = runs["scbf"]
    for r in scbf_res.records:
        if not 0.0 < r.upload_fraction < 1.0:
            raise AssertionError(f"scbf upload_fraction {r.upload_fraction}")
    want = K_LOOPS * K_CLIENTS * LAYERS
    if scbf_counts != {"channel_norm": want, "select_mask": want}:
        raise AssertionError(f"scbf kernel launches {scbf_counts}, want "
                             f"{want} each")
    return scbf_counts, cohort


def phase_profile(torch, cohort, card: str) -> None:
    """Where one SCBF loop's time goes: torch.profiler over one full-width
    loop (evaluation included), device busy share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated

    cfg = TrainConfig(learning_rate=0.05 / K_CLIENTS, global_loops=1,
                      local_epochs=2, local_batch_size=256, seed=0,
                      scbf=ScbfConfig(upload_rate=0.10, num_clients=K_CLIENTS))
    feats = (cohort.num_features, 256, 64, 1)
    run_federated(cohort, cfg, mlp_features=feats, device="cuda")   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_federated(cohort, cfg, mlp_features=feats, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        log("profile: device time not measured (the profiler recorded no "
            "CUDA events)")
        return
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    ours = {k: v for k, v in by_name.items()
            if any(s in k for s in ("partials_kernel", "finish_kernel",
                                    "select_mask_kernel"))}
    log("profile: " + json.dumps({
        "what": "one full-width SCBF loop + evaluation", "card": card,
        "wall_s": wall, "round_wall_s": res.records[0].wall_time,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernels": {k: {"launches": n, "device_us": us,
                        "us_per_launch": us / n}
                    for k, (n, us) in ours.items()},
        "top_by_device_us": [[k[:80], n, us] for k, (n, us) in top]}))


def phase_agreement(torch):
    """cuda run == cpu run of the port on one small input, same draws."""
    import numpy as np

    from repro_torch.config import ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import federated_split, generate_cohort
    from repro_torch.models.mlp_net import init_mlp
    from repro_torch.params import to_numpy

    feats, k, loops = (64, 32, 16, 1), 3, 2
    cohort = generate_cohort(num_admissions=1500, num_medicines=64, seed=0)
    sizes = [len(y) for _, y in federated_split(cohort.x_train,
                                                cohort.y_train, k, seed=0)]
    init = to_numpy(init_mlp(feats, torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(2)
    table = {(l, c, 0): rng.permutation(sizes[c])
             for l in range(loops) for c in range(k)}
    cfg = TrainConfig(learning_rate=0.05 / k, global_loops=loops,
                      local_batch_size=64, seed=0,
                      scbf=ScbfConfig(num_clients=k))
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
                abs(a.upload_fraction - b.upload_fraction) > 1e-2:
            raise AssertionError(f"cuda vs cpu loop {a.loop}: {a} != {b}")
    diff = max(float(np.max(np.abs(x[key] - y[key])))
               for x, y in zip(to_numpy(out["cuda"].final_params),
                               to_numpy(out["cpu"].final_params))
               for key in x)
    if diff > 1e-4:
        raise AssertionError(f"cuda vs cpu final params differ by {diff}")
    log(f"cuda vs cpu (small input): final params max abs diff {diff:.3g}, "
        f"sparse bytes identical: {same_bytes}")


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
    counts, cohort = phase_main_path(torch, card)
    phase_profile(torch, cohort, card)
    phase_agreement(torch)
    for r in report:
        r["launches"] = counts[r["name"]]
        log("kernel timing: " + json.dumps(
            {"kernel": r["name"], "kernel_ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_us": r["bound_ms"] * 1e3,
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "launches": r["launches"], "shape": r["shape"]}))
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
