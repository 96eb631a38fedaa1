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
6. obs (the flight recorder's device layer) at full width, under
   ``recording``: per-round SCBF 2 loops (the round events' loss,
   selected channels and bytes by codec; the carry's bytes those of the
   payloads; one offload a round; weights bitwise the main path's run;
   the loss finite and falling), fused SCBF 4 loops at ``fuse_rounds`` =
   2 (bitwise the fused phase's run, one offload a chunk, one capture,
   its chunk 1 under sync-debug "error", the losses the per-round run's
   to 1e-5, and one steady chunk profiled whole: K1 and K2 once a
   replay, one DtoH copy more than the collect-off chunk), fused FedAvg 2
   loops and mask-mode SCBFwP 8 loops (bitwise; the effective-geometry
   bytes the emitted payloads' each loop), ``debug_checks`` bitwise and a
   NaN in W0 named; every run's launches those of its collect-off run;
   then the collection's cost a fused loop, 3 alternating repeats.  Its
   lines start with ``obs:``.
7. cross-device at full width — FedBuff of 50 IID clients (concurrency
   20, buffer 10, stragglers 0.2, dropout 0.05): SCBF 6 rounds and
   mask-mode SCBFwP 4 rounds, K1, K2 and K3's count once a round whose
   participants start from different stale versions, one
   ``fedbuff_flush`` a full buffer; the storm (every fault kind, 5
   clients, the reject gate at ``MAX_UPDATE_NORM``) 6 loops per round
   and fused at ``fuse_rounds`` = 2, bitwise equal with the same
   rejection counters, a rejection each of checksum, duplicate,
   nonfinite and norm, one capture, the honest updates' norms and the
   CRC-32's host cost a round; deadline drop and spill at quantile 0.8,
   4 loops each; a quorum of 4 that retries.  Its lines start with
   ``cross-device:``.
8. C1 — one batched round of 256 participants at the paper's widths
   (the cohort split 256 ways, batch 32): one launch each of K1 (its
   workspace past the 2^22 words the library once held), K2 and K3's
   count, and every slot's selection and encoding bitwise its one-slot
   calls.
9. profile — torch.profiler over one more full-width loop of SCBF on
   each engine and of SCBFwP: the device's busy share, the host-device
   copies and the kernels that take its time.
10. small-input agreement — SCBF, SCBF with DP (normals injected) and
   SCBFwP (mask, compacted) on the batched engine, SCBFwP (mask,
   compacted) on the sequential one, fused SCBF with DP and fused
   SCBFwP (mask, compacted), FedBuff, and the storm per round and
   fused, on cuda and on the CPU (whose plain path the CPU tests hold
   against the JAX reference), from the same initial weights and
   permutations; the rejection counters and flushes equal.
11. lm — the dense LM zoo at full width: qwen2-0.5b (24 layers, d_model
   896, 14 heads on 2 KV heads, d_ff 4864, vocab 151,936, QKV bias,
   bf16, 630,167,424 params drawn on the card from a seed) through
   ``repro_torch.models.model_zoo``.  Serving through
   ``launch.serve.generate``: batch 4, prompt 32, 32 greedy tokens,
   cache 128 (prefill and decode ms, decode tok/s, peak memory), the
   first 4 decode steps' logits held against a cache-less forward over
   the same tokens (max |dlogit| <= LM_LOGIT_MAX, mean <= LM_LOGIT_MEAN)
   and every id in [0, V); one 1 x 1024 prefill over the query-chunked
   path (chunks of 512) against an unchunked forward.  Then 3 federated
   SCBF steps through ``core.distributed.make_federated_train_step`` (5
   clients x 4 sequences x 64 tokens, rate 0.10, lr 0.05): losses
   finite, K1 and K2 launched once a step and nothing else (one table of
   14 leaves x 5 slots), the step wall and peak memory, the kept
   fraction a client; on the last step's own gradient table K1's column
   norms within rtol 1e-5 of the plain version with no absolute floor,
   the channels its scores keep those the plain scores keep but at the
   threshold, K2's values, masks and counts bitwise (and its maskless
   mode's, which the step runs), the step's masked leaves the plain
   version's; then K1 and K2 timed on that table (one launch by CUDA
   events with the queue held ahead, and profiler device µs, beside
   their byte bounds); then torch.profiler over 3 steady decode steps
   and one more federated step (busy share, device events, top kernels;
   K1 and K2 once in the step, and a window with no event fails).  Its
   lines start with ``lm:``; the kernel report adds its launches to K1's
   and K2's and its timings as ``lm``.
12. lm-moe — the MoE models at every published width, cut to one period
   of their layer pattern (depth 2), bf16, weights drawn on the card from
   a seed, each freed before the next.  llama4-maverick ([dense, moe]:
   128 experts top-1 + 1 shared, 18,553,267,200 params) serves batch 4,
   prompt 32, 8 greedy tokens, cache 128 (prefill and decode ms, tok/s,
   peak memory; the tokens each expert received and those dropped at
   capacity 1.25), then K2 masks its bf16 expert stack ``wi`` as one
   matrix of 5,368,709,120 entries (past 2^31: row blocks in one launch)
   bitwise its plain version.  deepseek-v2 (MLA; the dense prefix layer
   and an MoE layer of 160 experts top-6 + 2 shared, 5,353,956,352
   params) serves batch 4, prompt 32, 32 greedy tokens from its latent
   cache; at a capacity that drops nothing (asserted) its decode is held
   against a cache-less forward (LM_LOGIT_MAX / LM_LOGIT_MEAN and greedy
   ids equal, but where the MoE routing flipped at a near-tie of the
   router) and a 1 x 1024 prefill over MLA's chunked path against an
   unchunked one; then 4 federated SCBF steps of 2 clients x 4 x 64
   tokens (losses finite, step walls, the peak memory under 60 GB, K1
   and K2 once a leaf table — two bf16 tables and the fp32 router's — and
   nothing else, one step profiled, the last step's tables against the
   plain versions: K1 within LM_K1_RTOL with no floor, K2 in place
   bitwise), and K1 and K2 timed on each table beside its byte bound.
   Its lines start with ``lm-moe:``; the kernel report adds its launches
   and its timings as ``lm_moe``.
13. lm-ssm — mamba2-2.7b uncut (64 layers, d_model 2560, 80 SSD heads of
   64, state 128, chunk 256, vocab 50,280; 2,830,624,256 params, bf16 with
   fp32 ``A_log`` and ``D_res``, drawn on the card from a seed; the count
   is the meta-device tree's, ``param_count()`` logged beside it): serving
   through ``launch.serve.generate`` (batch 4, prompt 32, 32 greedy
   tokens), the first decode steps (the O(1) recurrence) held against a
   cache-less forward (the chunked SSD; LM_LOGIT_MAX / LM_LOGIT_MEAN,
   greedy ids equal), the same check in fp32 at full width logged beside
   it, and a 1 x 1024 prefill (4 chunks of 256 through the inter-chunk
   loop) against one chunk of 1024; then 3 federated SCBF steps, the
   first of SSM_LONG_CLIENTS = 1 x 4 x 512 tokens (2 chunks of 256,
   where the reference's gradients are NaN: a finite loss and every
   gradient leaf finite), the others of SSM_CLIENTS = 2 clients x 4 x 64
   (clients and steps cut for the command's time; K1 and K2 once a leaf
   table — a bf16 table of 11 leaves and the fp32 one of ``A_log`` and
   ``D_res`` — from the wrapper counts and, in the first two steps, from
   the profiler over their selections; the peak under 60 GB; the third
   step's tables against the plain versions through ``MoeStepTap``); a
   client's gradient profiled (device activity only); K1 and K2 timed a
   table beside its byte bound.
   Then jamba-1.5-large at one period of its layer pattern (8 layers: 7
   Mamba, 1 attention, MoE every other layer) with 8 of its 16 experts
   (top-2 kept), both cuts stated: 25,816,813,824 params, serving batch
   4, prompt 32, 8 tokens at 1.25 (routing logged), and at a drop-free
   capacity its decode against the forward: each row's first routing
   flip at a router near-tie, the positions before it within the bounds.
   Its lines start with ``lm-ssm:``; the kernel report adds its launches
   and timings as ``lm_ssm``.
14. lm-encdec — whisper-medium uncut (24 encoder and 24 decoder layers,
   d_model 1024, 16 heads, d_ff 4096, vocab 51,865, cross-attention in
   every decoder layer to 1500 frames; 811,358,208 params, the meta
   tree's count, ``param_count()`` logged beside) and
   llama-3.2-vision-11b at all 40 layers (d_model 4096, 32 heads on 8 KV
   heads, d_ff 14,336, vocab 128,256, cross-attention every 5th layer to
   1024 patch tokens; 10,110,734,336 params), bf16, weights drawn on the
   card from a seed and context embeddings from a seeded device
   generator (normal, scale 1/sqrt(d_model)), each freed before the next.
   Each serves through ``launch.serve.generate`` (batch 4, prompt 32: a
   one-token prompt leaves the cross caches empty, ROADMAP C; 16 greedy
   tokens; whisper's encoder timed inside the prefill by CUDA events),
   its first decode steps (the cross caches written at prefill) held
   against a cache-less forward over the same tokens and context
   (LM_LOGIT_MAX / LM_LOGIT_MEAN, greedy ids equal but at a near-tie;
   whisper also in fp32 at full width within 1e-3 / 1e-4), and 3 decode
   steps profiled (device activity).  Then 3 federated SCBF steps of 5
   clients x 4 x 64 tokens, each client with its own context (K, B, T,
   D): whisper uncut, the vision model at one period of its pattern (5
   layers: the 40 layers' step would need about 80.8 GB; the cut is
   stated in its lines): losses finite and within 1.0 of ln V, K1 and K2
   once a leaf table (whisper 2, the vision period 4) and nothing else,
   the peak under 60 GB, the gradient phase timed apart, the last step's
   tables against the plain versions (``MoeStepTap``), a client's
   gradient profiled, and K1 and K2 timed a table.  Its lines start with
   ``lm-encdec:``; the kernel report adds its launches and timings as
   ``lm_encdec``.
15. comm-table — ``benchmarks/torch_table_communication.run(quick=False)``
   (MLP 2917-256-64-1, one client's upload at α 0.05 … 0.90 positive and
   0.10 negative): a ``comm-table:`` line a row, K1, K2 and K3's count
   once a row and K3's scatter once a row with a coo or bitmap weight
   leaf, every payload the host ``wire.encode`` of its masked delta; the
   fraction at α 0.10 beside the paper's 0.45 and the 0.98 of a real
   training delta.
16. pods — the pod axis (``launch.mesh``, the batched engine's slot
   split, the LM step's exchange).  (a) An NCCL group of one in this
   process: SCBF 2 loops per round and 4 fused loops at ``fuse_rounds`` =
   2 through the pod path, records and final weights bitwise the no-group
   runs above, the fused round one captured graph with the gather inside
   (one replay profiled beside a no-group replay: the device work it
   adds).  (b) Two ranks sharing cuda:0 over gloo (``spawn_ranks``; the
   kernels are built above, so no rank compiles): SCBF 2 loops, 2 with
   DP, 8 of SCBFwP mask with compaction and 4 fused (two graphs a round,
   the gather between), every rank's records and weights bitwise the
   no-group run, its launches that run's (K1, K2 and K3's count once a
   round, K4 once a validation batch of a prune step), the bytes it
   gathered a round beside the dense model's.  (c) qwen2-0.5b uncut on
   the same ranks: 2 dense steps and a compressed one of 4 clients x 4
   x 64 tokens, each against the one-rank step of the same params and
   batch (loss 1e-6 relative, bf16 params within one ulp, fp32 leaves
   1e-6), K1 = K2 = 1 a dense step a rank, bytes put into collectives,
   walls and peaks.  Two ranks on one card are no measure of scaling:
   their walls are logged, nothing is claimed.  Its lines start with
   ``pods:``.
17. mesh — the zoo on a ``(data, model)`` mesh (ROADMAP A15b): two gloo
   ranks sharing cuda:0 (``spawn_ranks``), params as DTensors placed by
   ``sharding.rules`` (DTensor's all-gathers and all-to-alls staged
   through host buffers, ``sharding.mesh.stage_gloo_gathers``).
   qwen2-0.5b uncut (bf16) on (1, 2) (tensor parallel) and (2, 1)
   (FSDP): a prefill of 4 x 32 and 4 decode steps fed the one-rank run's
   greedy ids, within LM_LOGIT_MAX / LM_LOGIT_MEAN of the one-rank
   logits; a federated step of MESH_CLIENTS x 4 x 64 against the
   one-rank step of the same params and batch (loss MESH_LOSS_REL, the
   share of bf16 entries that differ MESH_BF16_DIFFER, the difference's
   norm MESH_UPDATE_REL of the update's), each rank's K1 and K2 launches
   equal to the step's leaf tables, the bytes a rank puts into
   collectives (``launch.roofline.StepCounter``), walls and peaks; then
   the compressed exchange's step of the same batch against the one-rank
   compressed step under the same gates, each rank's chosen channels the
   top-k of the scores it holds and a choice that flips against the
   one-rank run's within δ of the k-th score, K1 = K2 = 0; and each
   step's memory counted by ``StepCounter`` within MESH_MEMORY_RATIO of
   the rise of ``torch.cuda.max_memory_allocated`` over it, and 0 B
   counted on ``"meta"`` in every counter window (the deepseek decode
   step's too): DTensor's sharding propagation holds no device's memory.
   deepseek-v2 at depth 2, every published width, drop-free, on (1, 2):
   80 of 160 experts a rank, a prefill into caches of MESH_MOE_CACHE
   slots and MESH_MOE_DECODE decode steps against the one-rank logits, a
   row whose routing flipped only at a router near-tie; every decode step
   through the sequence-parallel MLA on the latent cache's split
   (``models.layers._mla_attend_seq_shards``, counted), and the last one's
   collectives counted by kind, the MLA's held to a hand count and none
   taking a block of the cache.  No speed is claimed.  Its lines start with
   ``mesh:``; the kernel report adds each rank's step launches.
18. the card line, the kernel report line and the final ok line.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
T_START = time.perf_counter()

from repro_torch.config import HARDWARE  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet; the port's table): HBM bytes/s and
# fp32 (non-tensor) FLOP/s
PEAK_BYTES_S = HARDWARE.hbm_bw
PEAK_FP32_S = HARDWARE.peak_fp32
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
WINDOW_TAIL_S = 0.05                  # a profile window's idle tail a retry
FUSE_LOOPS, FUSE = 4, 2               # the fused SCBF run: 2 chunks of 2
BIG_ROUND, BIG_BATCH = 256, 32        # C1: one round of 256 participants
# the cross-device phase: FedBuff of 50 IID hospitals (~615 rows each),
# the every-fault storm at 5 clients under the reject gate, the clock and
# a round quorum
XD_CLIENTS, XD_ROUNDS, XD_WP_ROUNDS = 50, 6, 4
XD_FEDBUFF = dict(mode="fedbuff", concurrency=20, buffer_size=10,
                  straggler_rate=0.2, dropout_rate=0.05)
STORM = dict(enabled=True, seed=7, crash_rate=0.15, net_fail_rate=0.15,
             duplicate_rate=0.2, bitflip_rate=0.15, nan_rate=0.15,
             poison_rate=0.15)
STORM_LOOPS = 6
# the reject gate's bound: 41x the largest honest update norm the storm
# phase measured at full width on an H100 (0.0241); a poisoned update is
# 16x the bound
MAX_UPDATE_NORM = 1.0
CLOCK_LOOPS, DEADLINE_Q = 4, 0.8
QUORUM_LOOPS = 3
OBS_COST_LOOPS = 8                    # a run of the collection's cost


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
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
            bare, nomask, bare_counts = sm.select_mask_leaves(leaves,
                                                              masks=False)
            for k, leaf in enumerate(leaves):
                want = sm.select_mask_plain(*leaf)
                if not _same(torch, (outs[k], masks[k], counts[k]), want) \
                        or nomask[k] is not None or not _same(
                            torch, (bare[k], masks[k], bare_counts[k]),
                            want):
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


def device_us(torch, fn, names, launches: int, iters: int = 20,
              flush: bool = False) -> tuple:
    """(device µs per call in the kernels whose names hold one of
    ``names``, device µs per call in memsets), from torch.profiler over
    ``iters`` calls of ``fn``, which launches those kernels ``launches``
    times a call.  With ``flush``, FLUSH_BYTES are written between calls
    (a fill kernel, not counted), so each call meets its inputs in HBM and
    not in the 50 MB L2, as the main path's round does after a round's
    training.  A window whose count of those kernels falls short (the
    profiler lost events) is measured again, four times at most, each
    time with the host idle for WINDOW_TAIL_S more before the window
    closes; then, or if the profiler records no CUDA event, (None, None):
    not measured.  A short window logs every CUDA event it holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scratch = (torch.empty(FLUSH_BYTES // 4, device="cuda") if flush
               else None)
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if scratch is not None:
                    scratch.fill_(0.0)
                fn()
            torch.cuda.synchronize()
            time.sleep(attempt * WINDOW_TAIL_S)
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        ours = [e for e in events if any(s in e.name for s in names)]
        if len(ours) == launches * iters:
            if attempt:
                log(f"profile window of {names}: all {len(ours)} kernel "
                    f"events with the host idle "
                    f"{attempt * WINDOW_TAIL_S * 1e3:.0f} ms before it "
                    f"closed")
            return (sum(e.time_range.elapsed_us() for e in ours) / iters,
                    sum(e.time_range.elapsed_us() for e in events
                        if "Memset" in e.name) / iters)
        kinds = {}
        for e in events:
            kinds[e.name[:60]] = kinds.get(e.name[:60], 0) + 1
        log(f"profile window of {names} (host idle "
            f"{attempt * WINDOW_TAIL_S * 1e3:.0f} ms before it closed): "
            f"{len(ours)} kernel events, want {launches * iters}, of "
            f"{len(events)} CUDA events {kinds}; measuring again")
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
    t0 = time.perf_counter()
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
    log(f"kernels vs plain: checked in {time.perf_counter() - t0:.1f}s")
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
                # (payloads, stats), and the round's telemetry when the
                # run collects (under a recorder)
                out = _fn(eng, params, participants, *a, **k)
                payloads, stats = out[:2]
                p = len(participants)
                batched = eng.name == "batched"
                self.rounds.append({
                    "engine": eng.name, "participants": p,
                    "slots": bucket_size(p, eng.num_clients, eng.bucket)
                    if batched and p else p,
                    "uniform": eng.cohort.uniform if batched else None,
                    "payloads": payloads, "stats": stats})
                return out
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
                # a warm-up step first, and a first kernel of the active
                # step that is none of ours: a window's first device
                # activity can go unrecorded when tracing has just started
                # or stepped (the emission's first kernel was lost so)
                prof.start()
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                prof.step()
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
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
            "replays_by_run": replays,
            # the collect-off side of the obs phase's profiled chunk
            "chunk_windows": [chunk["window"], emitted["window"]]}


class ChunkWindow:
    """One torch.profiler window over the whole of fused chunk ``profile``
    (0-based) of a run — ``BatchedEngine.run_fused_chunk``: its replays,
    its emission and its telemetry's offload — with the wrapper launches
    and graph replays inside it."""

    def __init__(self, torch, profile: int = 1):
        from repro_torch.fed import engine as fe
        self.torch, self.cls, self.profile = torch, fe.BatchedEngine, profile
        self.saved = self.cls.run_fused_chunk
        self.calls = 0
        self.window = None

    def __enter__(self):
        torch, tap, fn = self.torch, self, self.saved

        def wrapped(eng, *a, **k):
            from torch.profiler import ProfilerActivity, profile, schedule

            from repro_torch.fed import graphs
            i, tap.calls = tap.calls, tap.calls + 1
            if i != tap.profile:
                return fn(eng, *a, **k)
            torch.cuda.synchronize()
            before, replays = _launch_counts(), graphs.replays
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           schedule=schedule(wait=0, warmup=1, active=1))
            # a warm-up step, and a first kernel of the active step that is
            # none of ours (as ChunkTap: a window's first device activity
            # can go unrecorded)
            prof.start()
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(eng, *a, **k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.stop()
            after = _launch_counts()
            tap.window = dict(_window(_device_events(prof), wall),
                              launches={n: after[n] - before[n]
                                        for n in after},
                              replays=graphs.replays - replays)
            return out

        self.cls.run_fused_chunk = wrapped
        return self

    def __exit__(self, *exc):
        self.cls.run_fused_chunk = self.saved


def obs_profile_check(torch, window: dict, off: list, card: str) -> dict:
    """The profiled collect-on chunk: K1 and K2 once a replay from its
    kernel events, K3 as its wrappers launched, and exactly one DtoH copy
    more than the collect-off chunk's replays and emission (``off``, the
    fused phase's two windows) — the telemetry's one offload.  Also the
    device events and busy time against the collect-off chunk's."""
    seen = window["kernel_launches"]
    want = dict(window["launches"], channel_norm=window["replays"],
                select_mask=window["replays"])
    d2h = window["copies_count_us"]["d2h"][0]
    off_d2h = [w["copies_count_us"]["d2h"][0] for w in off]
    if window["replays"] != FUSE or seen != want or \
            d2h != sum(off_d2h) + 1:
        raise AssertionError(
            f"obs: profiled collect-on chunk: {window['replays']} replays "
            f"(want {FUSE}), kernel events {seen} (want {want}), {d2h} DtoH "
            f"copies (want {sum(off_d2h)} + 1); trace "
            f"{window['top_by_device_us']}")
    return {"replays": window["replays"], "kernel_events": seen,
            "d2h_copies_collect_on": d2h,
            "d2h_copies_collect_off": off_d2h,
            "device_events_collect_on": window["events"],
            "device_events_collect_off": [w["events"] for w in off],
            "device_busy_s_collect_on": window["device_busy_s"],
            "device_busy_s_collect_off": [w["device_busy_s"] for w in off],
            "card": card}


def phase_obs(torch, cohort, card: str, runs: dict, fused: dict) -> None:
    """The flight recorder's device layer at full width (the paper's
    setting, cuda, under ``recording``): per-round SCBF 2 loops (the round
    events' device fields, the carry's bytes against the payloads', one
    offload a round, weights bitwise the main path's collect-off run, the
    loss finite and falling); fused SCBF S = 2, 4 loops (bitwise the fused
    phase's run, one offload a chunk, one capture, a sync-free chunk, the
    losses the per-round run's to 1e-5, and a profiled chunk: K1 and K2
    once a replay, one DtoH copy more than collect-off); fused FedAvg 2
    loops and mask-mode SCBFwP 8 loops (bitwise; the effective-geometry
    bytes the emitted payloads' every loop); ``debug_checks`` bitwise, and
    a NaN in W0 named; the launch counts of every run those of its
    collect-off run; the collection's cost a fused loop, measured (3
    alternating repeats, the minimum), not gated."""
    import numpy as np

    from repro_torch.config import FedConfig, ObsConfig, ScbfConfig, \
        TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.fed import graphs
    from repro_torch.obs import checks
    from repro_torch.obs import metrics as obsm
    from repro_torch.obs import trace

    t_phase = time.perf_counter()
    feats = (cohort.num_features, 256, 64, 1)
    wp = dict(prune=True, prune_rate=PRUNE_RATE, prune_total=PRUNE_TOTAL,
              prune_impl="mask", prune_compact=True)

    def cfg(method, loops, fuse, scbf=None, **kw):
        return TrainConfig(learning_rate=0.05 / K_CLIENTS
                           if method == "scbf" else 0.05,
                           global_loops=loops, local_epochs=2,
                           local_batch_size=256, seed=0,
                           scbf=ScbfConfig(upload_rate=0.10,
                                           num_clients=K_CLIENTS,
                                           **(scbf or {})),
                           fed=FedConfig(fuse_rounds=fuse), **kw)

    offloads = []
    real_offload = obsm.offload

    def tapped(carry, rounds=None):
        out = real_offload(carry, rounds=rounds)
        offloads.append(out)
        return out

    def run(label, method, loops, fuse, scbf=None, **kw):
        """A recorded run of the port; its result, launches, captures,
        replays, recorder and offloaded telemetry dicts (flat, a round
        each)."""
        graphs.reset_captures()
        _reset_launches()
        offloads.clear()
        with trace.recording() as rec:
            res = run_federated(cohort, cfg(method, loops, fuse, scbf, **kw),
                                method=method, mlp_features=feats,
                                device="cuda")
        counts = _launch_counts()
        dms = [d for o in offloads for d in (o if isinstance(o, list)
                                             else [o])]
        runs[label] = (res, counts, [])
        rounds = [e for e in rec.events if e["ev"] == "round"]
        for r, e in zip(res.records, rounds):
            log(f"[{label}] loop {r.loop} train_loss={r.train_loss} "
                f"selected={e.get('selected')} codec_bytes="
                f"{e.get('codec_bytes')} sparse_bytes={r.sparse_bytes} "
                f"wall_s={r.wall_time:.4f} ({card})")
        log(f"[{label}] kernel launches {counts}, captures "
            f"{graphs.captures}, replays {graphs.replays}, counters "
            f"{rec.counters}")
        return res, counts, graphs.captures, graphs.replays, rec, dms

    def same(a, b) -> bool:
        return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)

    def check(label, ok, what):
        if not ok:
            raise AssertionError(f"obs: {label}: {what}")

    obsm.offload = tapped
    try:
        # --- per-round SCBF, 2 loops --------------------------------------
        per, counts, _, _, rec, dms = run("obs_scbf_per_round", "scbf",
                                          K_LOOPS, 1)
        rounds = [e for e in rec.events if e["ev"] == "round"]
        losses = [r.train_loss for r in per.records]
        check("per-round", all({"train_loss", "selected", "codec_bytes"}
                               <= set(e) for e in rounds),
              f"round events {rounds}")
        check("per-round", [d["sparse_bytes"] for d in dms] ==
              [r.sparse_bytes for r in per.records] ==
              [sum(e["codec_bytes"].values()) for e in rounds],
              f"carry bytes {dms} against records "
              f"{[r.sparse_bytes for r in per.records]}")
        check("per-round", rec.counters["host_offloads"] == K_LOOPS,
              f"host_offloads {rec.counters['host_offloads']}")
        check("per-round", same(per.final_params,
                                runs["scbf"][0].final_params),
              "final weights differ from the collect-off run's")
        check("per-round", all(math.isfinite(x) for x in losses)
              and losses[1] < losses[0], f"train_loss {losses}")
        check("per-round", counts == runs["scbf"][1],
              f"launches {counts} against {runs['scbf'][1]}")

        # --- fused SCBF, S = 2, 4 loops, its chunk 1 sync-free -------------
        with ChunkTap(torch, guard=1) as tap:
            fz, fz_counts, caps, reps, rec, fz_dms = run(
                "obs_scbf_fused", "scbf", FUSE_LOOPS, FUSE)
        off = runs["scbf_fused"]
        loss_diff = max(abs(a.train_loss - b.train_loss)
                        for a, b in zip(fz.records, per.records))
        check("fused", same(fz.final_params, off[0].final_params),
              "final weights differ from the collect-off fused run's")
        check("fused", rec.counters["host_offloads"] == FUSE_LOOPS // FUSE
              and caps == 1 and reps == FUSE_LOOPS
              and fz_counts == off[1] and
              tap.calls["fused_scbf_chunk"][1]["replays"] == FUSE,
              f"host_offloads {rec.counters['host_offloads']}, captures "
              f"{caps}, replays {reps}, launches {fz_counts} against "
              f"{off[1]}")
        check("fused", [d["sparse_bytes"] for d in fz_dms] ==
              [r.sparse_bytes for r in fz.records], f"carry bytes {fz_dms}")
        check("fused", loss_diff <= 1e-5,
              f"train_loss {[r.train_loss for r in fz.records]} against "
              f"per round {losses}")
        with ChunkWindow(torch) as win:
            run("obs_scbf_fused_profiled", "scbf", FUSE_LOOPS, FUSE)
        runs.pop("obs_scbf_fused_profiled")
        prof = obs_profile_check(torch, win.window,
                                 fused["chunk_windows"], card)
        log("obs: " + json.dumps({
            "run": "fused scbf, fuse_rounds=2, 4 loops, collect on",
            "card": card, "captures": caps, "replays": reps,
            "host_offloads": rec.counters["host_offloads"],
            "sync_debug_error_chunk": 1,
            "train_loss": [r.train_loss for r in fz.records],
            "train_loss_max_abs_diff_vs_per_round": loss_diff,
            "final_weights_bitwise_collect_off": True,
            "profiled_chunk": prof,
            "profiled_chunk_wall_s": win.window["wall_s"]}))

        # --- fused FedAvg 2 loops, fused SCBFwP mask 8 loops --------------
        fa, fa_counts, fa_caps, _, rec, fa_dms = run(
            "obs_fedavg_fused", "fedavg", 2, FUSE)
        check("fused fedavg", same(fa.final_params,
                                   runs["fedavg_fused"][0].final_params)
              and fa_caps == 1 and rec.counters["host_offloads"] == 1
              and fa_counts == runs["fedavg_fused"][1]
              and all(math.isfinite(r.train_loss) for r in fa.records),
              f"captures {fa_caps}, counters {rec.counters}, launches "
              f"{fa_counts}, losses {[r.train_loss for r in fa.records]}")
        wpr, wp_counts, wp_caps, _, rec, wp_dms = run(
            "obs_scbfwp_mask_fused", "scbf", WP_LOOPS, FUSE, wp)
        ref = runs["scbfwp_mask_fused"]
        check("fused scbfwp mask", same(wpr.final_params,
                                        ref[0].final_params)
              and [r.hidden_sizes for r in wpr.records] ==
              [r.hidden_sizes for r in ref[0].records]
              and wp_caps <= 2 and wp_counts == ref[1],
              f"captures {wp_caps}, launches {wp_counts} against {ref[1]}")
        check("fused scbfwp mask", [d["sparse_bytes"] for d in wp_dms] ==
              [r.sparse_bytes for r in wpr.records],
              f"carry bytes {[d['sparse_bytes'] for d in wp_dms]} against "
              f"the payloads' {[r.sparse_bytes for r in wpr.records]}")
        log("obs: " + json.dumps({
            "run": "fused fedavg 2 loops and scbfwp mask 8 loops, collect "
                   "on", "card": card,
            "fedavg_train_loss": [r.train_loss for r in fa.records],
            "scbfwp_carry_sparse_bytes": [d["sparse_bytes"]
                                          for d in wp_dms],
            "scbfwp_payload_sparse_bytes": [r.sparse_bytes
                                            for r in wpr.records],
            "scbfwp_hidden": [r.hidden_sizes for r in wpr.records],
            "scbfwp_captures": wp_caps,
            "final_weights_bitwise_collect_off": True}))

        # --- debug_checks -------------------------------------------------
        chk, chk_counts, _, _, _, _ = run("obs_scbf_fused_checked", "scbf",
                                          FUSE_LOOPS, FUSE,
                                          debug_checks=True)
        check("debug_checks", same(chk.final_params, off[0].final_params)
              and chk_counts == off[1],
              "a checked fused run differs from its unchecked run")
        bad = tuple({k: v.clone() for k, v in layer.items()}
                    for layer in chk.final_params)
        bad[0]["w"][3, 7] = float("nan")
        try:
            checks.verify_round(bad, None, where="smoke")
            raise AssertionError("obs: verify_round passed a NaN in W0")
        except checks.DebugCheckError as e:
            msg = str(e)
        check("debug_checks", "'0/w'" in msg and "1 nan / 0 inf" in msg,
              msg)
        log(f"obs: debug_checks fused run bitwise its unchecked run; a NaN "
            f"in W0 on cuda: {msg} ({card})")
    finally:
        obsm.offload = real_offload

    # --- the collection's cost a fused loop (recorded, not gated) ----------
    walls = {"off": [], "on": []}
    for _ in range(3):
        for side in ("off", "on"):
            res = run_federated(cohort, cfg(
                "scbf", OBS_COST_LOOPS, FUSE,
                obs=ObsConfig(device_metrics=side == "on")),
                method="scbf", mlp_features=feats, device="cuda")
            # the steady chunks' loops (chunk 0 holds the capture)
            walls[side].append(float(np.mean([r.wall_time for r in
                                              res.records[FUSE:]])))
    best = {k: min(v) for k, v in walls.items()}
    log("obs: " + json.dumps({
        "what": f"fused SCBF loop wall (mean of {OBS_COST_LOOPS - FUSE} "
                "steady loops, amortised), device metrics off and on, 3 "
                "alternating repeats", "card": card,
        "loop_wall_s": walls, "min_loop_wall_s": best,
        "collection_overhead_s_a_loop": best["on"] - best["off"],
        "collection_overhead_share": (best["on"] - best["off"])
        / best["off"]}))
    log(f"obs: phase wall {time.perf_counter() - t_phase:.1f}s ({card})")


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


def _round_events(rec) -> list:
    return [e for e in rec.events if e["ev"] == "round"]


def _rejections(rec) -> dict:
    return {k: v for k, v in sorted(rec.counters.items())
            if k.startswith(("rejected_", "payloads_", "rounds_",
                             "quorum_"))}


def _verdicts(rec) -> dict:
    """The rejection counters with a bit flip's two verdicts merged: the
    flipped byte's position depends on the payload's size, and a flip in
    a length or index field is ``malformed`` where one in a value is
    ``checksum`` (the reference's oracle accepts either)."""
    out = _rejections(rec)
    out["rejected_bitflip"] = out.pop("rejected_checksum", 0) + \
        out.pop("rejected_malformed", 0)
    return out


def _payload_norm(payload) -> float:
    """The admission gate's L2 norm of one payload (float64 sum)."""
    import numpy as np
    return float(np.sqrt(sum(float(np.sum(np.square(
        np.asarray(lp.values), dtype=np.float64))) for lp in payload.layers)))


def phase_cross_device(torch, cohort, card: str, runs: dict) -> None:
    """The cross-device scenarios at full width (the cohort of the main
    path, MLP 2917-256-64-1, batched engine), each run with the launch
    counts set to 0 before it and read after it, and its flight-recorder
    events:

    - FedBuff: 50 IID clients, concurrency 20, buffer 10, stragglers 0.2,
      dropout 0.05, SCBF 6 rounds, then mask-mode SCBFwP 4 rounds: K1,
      K2 and K3's count once a round (a round whose participants start
      from different stale versions among them), one ``fedbuff_flush``
      a full buffer, K4 once a validation batch of a prune step;
    - the storm (every fault kind at once, 5 clients, the reject gate at
      ``MAX_UPDATE_NORM``) for 6 loops per round and fused at
      ``fuse_rounds`` = 2: final weights bitwise equal, the same
      rejection counters, a rejection each of checksum, duplicate,
      nonfinite and norm, one capture; the honest payloads' norms (all
      below the bound) and the host cost of sealing a round's payloads
      (CRC-32) logged;
    - the simulated clock: deadline ``drop`` and ``spill`` at quantile
      0.8, 4 loops each (spill delivers a late upload trained from an
      earlier round's model);
    - a round quorum of 4 with crash rate 0.3: at least one
      ``round_retried``."""
    import numpy as np

    from repro_torch.comm import wire
    from repro_torch.config import (ClockConfig, FaultConfig, FedConfig,
                                    ScbfConfig, TrainConfig)
    from repro_torch.core.scbf import run_federated
    from repro_torch.fed import graphs
    from repro_torch.obs import Recorder, recording

    feats = (cohort.num_features, 256, 64, 1)
    wp = dict(prune=True, prune_rate=PRUNE_RATE, prune_total=PRUNE_TOTAL,
              prune_impl="mask")

    def xlog(msg: str) -> None:
        log(f"cross-device: {msg}")

    def cfg(loops, clients=K_CLIENTS, scbf=None, **fed):
        return TrainConfig(learning_rate=0.05 / K_CLIENTS,
                           global_loops=loops, local_epochs=2,
                           local_batch_size=256, seed=0,
                           scbf=ScbfConfig(upload_rate=0.10,
                                           num_clients=clients,
                                           **(scbf or {})),
                           fed=FedConfig(**fed))

    def run(label, c, prune_steps=0):
        rec = Recorder()
        graphs.reset_captures()
        with RoundTap() as tap, recording(recorder=rec):
            _reset_launches()
            res = run_federated(cohort, c, method="scbf",
                                mlp_features=feats, device="cuda")
            counts = _launch_counts()
        runs[label] = (res, counts, [])
        for r, e in zip(res.records, _round_events(rec)):
            xlog(f"[{label}] loop {r.loop} clients={r.num_participants} "
                f"staleness_mean={e['staleness_mean']:.3f} "
                f"staleness_max={e['staleness_max']} "
                f"deadline_s={e.get('deadline_s')} "
                f"spilled={e.get('spilled')} auc_roc={r.auc_roc:.4f} "
                f"sparse_bytes={r.sparse_bytes} "
                f"hidden={'x'.join(map(str, r.hidden_sizes))} "
                f"wall_s={r.wall_time:.4f} amortized={r.wall_is_amortized} "
                f"({card})")
        xlog(f"[{label}] kernel launches {counts}, captures "
            f"{graphs.captures}, counters {_rejections(rec)}")
        for r in res.records:
            for v in (r.auc_roc, r.auc_pr):
                if not (math.isfinite(v) and 0.0 <= v <= 1.0):
                    raise AssertionError(f"{label} loop {r.loop}: AUC {v}")
        for layer in res.final_params:
            for v in layer.values():
                if v.device.type != "cuda" or not torch.isfinite(v).all():
                    raise AssertionError(f"{label}: final params not "
                                         "finite on cuda")
        if not c.fed.fuse_rounds > 1:
            units = len(tap.units())
            want = {"channel_norm": units, "select_mask": units,
                    "select_compact_count": units,
                    "select_compact_scatter": tap.scatter_units(),
                    "apoz": prune_steps * VAL_BATCHES}
            if counts != want:
                raise AssertionError(f"{label} kernel launches {counts}, "
                                     f"want {want}")
        return res, rec, tap

    # ---- FedBuff: hospitals report when their local job finishes ----
    for label, loops, scbf in (("fedbuff", XD_ROUNDS, None),
                               ("fedbuff_scbfwp_mask", XD_WP_ROUNDS, wp)):
        res, rec, tap = run(label, cfg(loops, XD_CLIENTS, scbf,
                                       **XD_FEDBUFF),
                            prune_steps=loops if scbf else 0)
        rounds = _round_events(rec)
        mixed = [e["loop"] for e in rounds if e["participants"] > 1
                 and e["staleness_mean"] < e["staleness_max"]]
        if not mixed:
            raise AssertionError(f"{label}: no round trained from mixed "
                                 "stale versions")
        flushes = [e for e in rec.events if e["ev"] == "fedbuff_flush"]
        uploads = sum(e["participants"] for e in rounds)
        if len(flushes) != uploads // XD_FEDBUFF["buffer_size"] or any(
                f["buffered"] != XD_FEDBUFF["buffer_size"] for f in flushes):
            raise AssertionError(f"{label}: {len(flushes)} flushes for "
                                 f"{uploads} uploads")
        slots = [r["slots"] for r in tap.rounds]
        xlog(f"[{label}] rounds from mixed stale versions {mixed} (one K1, "
            f"K2 and K3 count launch each), {len(flushes)} flushes of "
            f"{XD_FEDBUFF['buffer_size']} for {uploads} uploads, slots a "
            f"round {slots}, versions "
            f"{[f['version'] for f in flushes]} ({card})")

    # ---- the storm: per round and fused, under the reject gate ----
    storm = dict(faults=FaultConfig(**STORM),
                 max_update_norm=MAX_UPDATE_NORM)
    per, per_rec, per_tap = run("storm", cfg(STORM_LOOPS, **storm))
    fused, fused_rec, _ = run("storm_fused", cfg(STORM_LOOPS, fuse_rounds=2,
                                                  **storm))
    if graphs.captures != 1:
        raise AssertionError(f"storm fused: {graphs.captures} captures")
    if not all(torch.equal(a[k], b[k]) for a, b in
               zip(per.final_params, fused.final_params) for k in a):
        raise AssertionError("storm: fused weights differ from per-round")
    if _rejections(per_rec) != _rejections(fused_rec):
        raise AssertionError(f"storm counters {_rejections(per_rec)} != "
                             f"fused {_rejections(fused_rec)}")
    reasons = {e["reason"] for e in per_rec.events
               if e["ev"] == "payload_rejected"}
    if not {"checksum", "duplicate", "nonfinite", "norm"} <= reasons:
        raise AssertionError(f"storm rejected only {sorted(reasons)}")
    honest = [_payload_norm(p) for unit in per_tap.units() for p in unit]
    if max(honest) >= MAX_UPDATE_NORM:
        raise AssertionError(f"an honest update's norm {max(honest)} is "
                             f"past the bound {MAX_UPDATE_NORM}")
    seal_ms = []
    for unit in per_tap.units():
        t0 = time.perf_counter()
        for i, p in enumerate(unit):
            wire.seal(p, i, 0)
        seal_ms.append((time.perf_counter() - t0) * 1e3)
    mb = [sum(p.nbytes for p in unit) / 1e6 for unit in per_tap.units()]
    xlog("storm " + json.dumps({
        "card": card, "bitwise_fused_vs_per_round": True,
        "counters": _rejections(per_rec), "reasons": sorted(reasons),
        "honest_norm_min": min(honest),
        "honest_norm_median": float(np.median(honest)),
        "honest_norm_max": max(honest), "max_update_norm": MAX_UPDATE_NORM,
        "seal_ms_a_round": seal_ms, "payload_mb_a_round": mb,
        "loop_wall_s": [r.wall_time for r in per.records],
        "fused_loop_wall_s": [r.wall_time for r in fused.records]}))

    # ---- the simulated clock: deadline drop and spill ----
    for action in ("drop", "spill"):
        res, rec, _ = run(f"clock_{action}", cfg(
            CLOCK_LOOPS, clock=ClockConfig(enabled=True,
                                           deadline_quantile=DEADLINE_Q,
                                           deadline_action=action)))
        rounds = _round_events(rec)
        if not all(e.get("deadline_s", 0) > 0 for e in rounds) or \
                not any(e["participants"] < K_CLIENTS for e in rounds):
            raise AssertionError(f"clock {action}: no deadline cut")
        late = [e["loop"] for e in rounds if e["staleness_max"] > 0]
        if (action == "spill") != bool(late):
            raise AssertionError(f"clock {action}: late arrivals {late}")

    # ---- a round quorum that needs a retry ----
    res, rec, _ = run("quorum", cfg(QUORUM_LOOPS, faults=FaultConfig(
        enabled=True, seed=0, crash_rate=0.3), min_valid_participants=4,
        round_retries=3))
    if not rec.counters.get("rounds_retried", 0) or \
            rec.counters.get("quorum_misses", 0):
        raise AssertionError(f"quorum: counters {_rejections(rec)}")


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
    big_round_split(torch, eng, params, part, perms, card)


BIG_SPLITS = ((0, 1), (0, 2), (0, 12), (0, BIG_ROUND // 2),
              (BIG_ROUND // 2, BIG_ROUND))


def big_round_split(torch, eng, params, part, perms, card: str) -> None:
    """C1's round as the pods would split it: ``_slot_pass`` (DP and the
    telemetry carry on) over slots [a, e) of the 256 alone — 1, 2, 12
    and a rank's 128 of two pods, the first half and the second — each
    bitwise those slots of the whole pass, masked deltas, masks and
    carry: a slot's bits do not depend on how many slots share its
    products, clip norms and selection (``repro_torch.slots``)."""
    from repro_torch.config import ScbfConfig
    from repro_torch.fed.engine import _slot_pass

    cfg = ScbfConfig(upload_rate=0.10, **DP)
    rows, valid, pm = eng._slot_inputs(part, perms, BIG_ROUND)
    noise = eng.draw_noise(params, BIG_ROUND, generator=torch.Generator(
        device="cuda").manual_seed(6))

    def run(a, e):
        masked, masks, met = _slot_pass(
            params, eng.cohort, rows[a:e], valid[a:e], 0.01, pm[a:e], cfg,
            batch_size=BIG_BATCH, epochs=1, noise=[z[a:e] for z in noise],
            collect=True)
        return [t for layer in masked for t in layer.values()] + \
            [t for layer in masks for t in layer.values()
             if t is not None] + list(met)

    whole = run(0, BIG_ROUND)
    t0 = time.perf_counter()
    for a, e in BIG_SPLITS:
        got = run(a, e)
        bad = [i for i, (w, g) in enumerate(zip(whole, got))
               if not torch.equal(w[a:e], g)]
        if bad or len(got) != len(whole):
            raise AssertionError(f"c1 split: slots [{a}, {e}) alone differ "
                                 f"from the {BIG_ROUND}-slot pass in "
                                 f"outputs {bad}")
    torch.cuda.synchronize()
    log(f"c1 split: slots {[list(r) for r in BIG_SPLITS]} of the "
        f"{BIG_ROUND}-slot round (DP, carry) through _slot_pass alone: "
        f"masked deltas, masks and carry bitwise the whole pass's "
        f"({len(whole)} tensors each; {time.perf_counter() - t0:.1f}s) "
        f"({card})")


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
        # no warm-up run: the main path ran this configuration already
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
    cuda, eager on the CPU); SCBFwP in mask mode with compaction on the
    sequential engine; FedBuff, and the storm per round and fused (the
    same rejection counters and flushes on both devices)."""
    import numpy as np

    from repro_torch.config import (FaultConfig, FedConfig, ScbfConfig,
                                    TrainConfig)
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import federated_split, generate_cohort
    from repro_torch.models.mlp_net import init_mlp
    from repro_torch.obs import Recorder, recording
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
    fedbuff = dict(mode="fedbuff", concurrency=3, buffer_size=2,
                   straggler_rate=0.3)
    storm = dict(faults=FaultConfig(**STORM), max_update_norm=100.0)
    for label, scbf, engine, fuse, fed in (
            ("scbf", {}, "batched", 1, {}), ("scbf_dp", DP, "batched", 1, {}),
            ("scbfwp_mask", wp_mask, "batched", 1, {}),
            ("scbfwp_mask_sequential", wp_mask, "sequential", 1, {}),
            ("scbf_dp_fused", DP, "batched", loops, {}),
            ("scbfwp_mask_fused", wp_mask, "batched", 2, {}),
            ("fedbuff", {}, "batched", 1, fedbuff),
            ("storm", {}, "batched", 1, storm),
            ("storm_fused", {}, "batched", 2, storm)):
        cfg = TrainConfig(learning_rate=0.05 / k, global_loops=loops,
                          local_batch_size=64, seed=0,
                          scbf=ScbfConfig(num_clients=k, **scbf),
                          fed=FedConfig(engine=engine, fuse_rounds=fuse,
                                        **fed))
        out, recs = {}, {}
        for dev in ("cuda", "cpu"):
            recs[dev] = Recorder()
            with recording(recorder=recs[dev]):
                out[dev] = run_federated(
                    cohort, cfg, method="scbf", mlp_features=feats,
                    device=dev, init_params=init,
                    perms=lambda l, c, e: table[(l, c, e)],
                    dp_noise=normals)
        if _verdicts(recs["cuda"]) != _verdicts(recs["cpu"]) or [
                e["version"] for e in recs["cuda"].events
                if e["ev"] == "fedbuff_flush"] != [
                e["version"] for e in recs["cpu"].events
                if e["ev"] == "fedbuff_flush"]:
            raise AssertionError(f"{label} cuda vs cpu: counters "
                                 f"{_rejections(recs['cuda'])} != "
                                 f"{_rejections(recs['cpu'])} or flushes")
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
            f"{out['cuda'].records[-1].hidden_sizes}, counters "
            f"{_rejections(recs['cuda'])}")


# the lm phase: qwen2-0.5b at full width, bf16, random weights from a seed
LM_ARCH = "qwen2-0.5b"
LM_SERVE = dict(batch=4, prompt=32, gen=32, cache=128)
LM_LONG = 1024                        # one prefill over the chunked path
LM_CLIENTS, LM_BATCH, LM_SEQ, LM_RATE, LM_LR = 5, 4, 64, 0.10, 0.05
LM_STEPS = 3
LM_DECODE_CHECKED = 4                 # decode steps held to the forward
# bf16 logits through the cache against the cache-less forward: both round
# every activation to bf16 (an ulp is 2^-6 at |logit| 2-4), on GEMMs of
# other shapes, so the sums differ in order
LM_LOGIT_MAX, LM_LOGIT_MEAN = 0.25, 0.02
# K1 against its plain version on the LM table, relative and with no
# absolute floor: both sum fp32 squares of the same bf16 entries in other
# orders
LM_K1_RTOL = 1e-5
# cycles the stream sleeps ahead of a timed launch: about 10 ms at the
# H100's 1.98 GHz boost clock, longer than the host takes to launch K1 or K2
LM_QUEUE_CYCLES = 20_000_000


def _peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def _decode_vs_forward(torch, bundle, params, prompts, res, n: int,
                       aux=None) -> dict:
    """The first ``n`` logits of a greedy ``generate`` (logits[i] is the
    prediction at position prompt - 1 + i) against a cache-less forward
    over the same tokens (reading the context tokens ``aux``, if the model
    cross-attends): the largest |dlogit|, the largest mean |dlogit| of a
    position, at how many positions the greedy ids are equal, and at how
    many (row, position) pairs they differ where the forward's top two
    logits lie more than twice that pair's largest |dlogit| apart (away
    from a near-tie of the argmax)."""
    from repro_torch.models import transformer as T

    cfg, prompt = bundle.cfg, prompts.shape[1]
    seq = torch.cat([prompts, res.tokens[:, :n - 1]], axis=1)
    with torch.no_grad():
        h, _ = T.forward_hidden(params, cfg, seq, bundle.ctx, aux=aux)
        full = T.logits_from_hidden(params, cfg, h)[:, prompt - 1:].float()
    diffs = (torch.stack(res.logits[:n], 1).float() - full).abs()
    greedy = torch.argmax(full, -1).to(torch.int32) == res.tokens[:, :n]
    top2 = torch.topk(full, 2, axis=-1).values
    tie = top2[..., 0] - top2[..., 1] <= 2 * diffs.amax(-1)
    return {"logit_max_abs": float(diffs.max()),
            "logit_mean_abs": float(diffs.mean(axis=(0, 2)).max()),
            "greedy_agree": int(greedy.all(0).sum()),
            "greedy_off_tie": int((~greedy & ~tie).sum())}


def lm_serve(torch, bundle, params, card: str) -> dict:
    """Serving at full width through ``launch.serve.generate``: a warm-up
    call, the timed batch (greedy), its first decode steps held against a
    cache-less forward over the same tokens, and one 1 x LM_LONG prefill
    (query-chunked) held against an unchunked forward."""
    import dataclasses

    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    cfg = bundle.cfg
    sv = LM_SERVE
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (sv["batch"], sv["prompt"]),
                            generator=gen, dtype=torch.int32, device="cuda")
    generate(bundle, params, prompts, 2, sv["cache"])          # warm-up
    torch.cuda.reset_peak_memory_stats()
    res = generate(bundle, params, prompts, sv["gen"], sv["cache"])
    toks = res.tokens
    if not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"lm: token ids outside [0, {cfg.vocab_size})")
    decoded = sv["batch"] * (sv["gen"] - 1)
    out = {"prefill_ms": res.prefill_s * 1e3, "decode_ms": res.decode_s * 1e3,
           "decode_tok_s": decoded / res.decode_s,
           "prefill_tok_s": sv["batch"] * sv["prompt"] / res.prefill_s,
           "peak_gb": _peak_gb(torch)}
    out.update(_decode_vs_forward(torch, bundle, params, prompts, res,
                                  LM_DECODE_CHECKED + 1))
    if not (out["logit_max_abs"] <= LM_LOGIT_MAX
            and out["logit_mean_abs"] <= LM_LOGIT_MEAN):
        raise AssertionError(f"lm: decode through the cache against the "
                             f"full forward: {out}")
    # one long prompt: 1 x LM_LONG tokens take the query-chunked path
    long = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen,
                         dtype=torch.int32, device="cuda")
    if not (LM_LONG > bundle.ctx.q_chunk and LM_LONG % bundle.ctx.q_chunk
            == 0):
        raise AssertionError("lm: the long prefill must take the chunked "
                             "path")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, _ = bundle.prefill_step(params, {
        "tokens": long, "caches": bundle.make_cache(1, LM_LONG)})
    torch.cuda.synchronize()
    out["long_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    whole = dataclasses.replace(bundle.ctx, q_chunk=2 * LM_LONG)
    with torch.no_grad():
        h, _ = T.forward_hidden(params, cfg, long, whole)
        ref = T.logits_from_hidden(params, cfg, h[:, -1]).float()
    out["long_max_abs"] = float((lg.float() - ref).abs().max())
    if not (torch.isfinite(lg).all() and out["long_max_abs"]
            <= LM_LOGIT_MAX):
        raise AssertionError(f"lm: the chunked long prefill: {out}")
    log(f"lm: serve {cfg.name} batch {sv['batch']} prompt {sv['prompt']} "
        f"gen {sv['gen']} cache {sv['cache']}: prefill "
        f"{out['prefill_ms']:.2f} ms, decode {out['decode_ms']:.1f} ms "
        f"({out['decode_tok_s']:.1f} tok/s), peak {out['peak_gb']:.2f} GB; "
        f"decode vs full forward over {LM_DECODE_CHECKED + 1} positions: max "
        f"|dlogit| {out['logit_max_abs']:.4g}, mean {out['logit_mean_abs']:.3g}"
        f", greedy ids equal at {out['greedy_agree']} of "
        f"{LM_DECODE_CHECKED + 1}; 1 x {LM_LONG} prefill (chunked by "
        f"{bundle.ctx.q_chunk}) {out['long_prefill_ms']:.1f} ms, max "
        f"|dlogit| vs unchunked {out['long_max_abs']:.4g} ({card})")
    return out


def _lm_table(torch, grads_k):
    """A federated step's K1 column scores and K2 table, as
    ``core.channels.factored_mask_slots`` builds it: every scored leaf as
    (clients, M, N), zero row scores shared by the clients, the column
    scores, the float below each client's threshold and rest 0.  Returns
    (leaf indices, scores, thresholds, table)."""
    from repro_torch.core import channels as ch

    leaves, scores = ch.factored_scores_slots(grads_k)
    thr = ch.factored_threshold(scores, LM_RATE)
    below = torch.nextafter(thr, torch.full_like(thr, float("-inf")))
    rest = torch.zeros((), device="cuda")
    idx = [i for i, s in enumerate(scores) if s is not None]
    table = []
    for i in idx:
        mats = ch._matrices(leaves[i])
        table.append((mats, torch.zeros(mats.shape[1], device="cuda"),
                      scores[i], below, rest))
    return idx, scores, thr, table


def lm_table_checks(torch, grads_k, masked, frac) -> dict:
    """On one federated step's own gradient table (14 leaves x 5 clients,
    bf16): K1's column norms within rtol LM_K1_RTOL of the plain version,
    with no absolute floor (the unembedding's scores sit near 1e-9, below
    any floor of the MLP checks); the channels kept from K1's scores and
    their threshold against those kept from the plain scores and a
    threshold of their own, a flip allowed only where the plain score ties
    the plain threshold within 2 x LM_K1_RTOL; K2's values, masks and
    counts bitwise its plain version's, and its maskless mode's (the
    step's) values and counts bitwise too; the step's masked leaves the
    plain version's."""
    from repro_torch.core import channels as ch
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    idx, scores, thr, table = _lm_table(torch, grads_k)
    plain, rel = {}, 0.0
    for i, (mats, *_) in zip(idx, table):
        _, pcol = cn.channel_norms_plain(mats)
        torch.testing.assert_close(scores[i], pcol, rtol=LM_K1_RTOL, atol=0.0)
        rel = max(rel, float(((scores[i] - pcol).abs()
                              / pcol.abs().clamp_min(1e-38)).max()))
        plain[i] = pcol
    pthr = ch.factored_threshold([plain.get(i) for i in range(len(scores))],
                                 LM_RATE)
    flips = 0
    for i in idx:
        diff = (scores[i] >= thr[:, None]) != (plain[i] >= pthr[:, None])
        tie = (plain[i] - pthr[:, None]).abs() <= \
            2 * LM_K1_RTOL * pthr.abs()[:, None]
        if bool(torch.any(diff & ~tie)):
            raise AssertionError(f"lm: K1's scores keep other channels of "
                                 f"leaf {i} than the plain scores do, away "
                                 f"from the threshold")
        flips += int(torch.count_nonzero(diff))
    median = ch.quantile(torch.cat([plain[i] for i in idx], axis=-1), 0.5,
                         axis=-1)
    unembed = idx[-1]               # the last leaf in flatten order
    outs, kmasks, counts = sm.select_mask_leaves(table)
    bare, _, bare_counts = sm.select_mask_leaves(table, masks=False)
    if not torch.equal(bare_counts, counts):
        raise AssertionError("lm: select_mask counts differ without masks")
    counts = counts.view(len(idx), LM_CLIENTS)
    for j, (i, leaf) in enumerate(zip(idx, table)):
        pout, pmask, pcnt = sm.select_mask_plain(*leaf)
        if not (torch.equal(outs[j], pout) and torch.equal(kmasks[j], pmask)
                and torch.equal(counts[j], pcnt)
                and torch.equal(bare[j], pout)):
            raise AssertionError(f"lm: select_mask differs from plain on "
                                 f"leaf {i} {tuple(leaf[0].shape)}")
        step_leaf = masked[i]
        if not torch.equal(step_leaf.reshape(pout.shape), pout):
            raise AssertionError(f"lm: the step's masked leaf {i} is not "
                                 f"the plain version's")
        del pout, pmask
    torch.cuda.synchronize()
    return {"leaves": len(idx), "slots": LM_CLIENTS, "k1_max_rel_err": rel,
            "threshold": [float(t) for t in thr.cpu()],
            "plain_threshold": [float(t) for t in pthr.cpu()],
            "median_score": [float(m) for m in median.cpu()],
            "unembed_median_score": float(plain[unembed].median()),
            "channel_flips": flips,
            "kept_fraction": [float(f) for f in frac.cpu()]}


def queued_ms(torch, fn, iters: int = 7) -> float:
    """Device ms of one call of ``fn``: CUDA events around the call with
    the stream held busy ahead of it (``torch.cuda._sleep``), so that the
    host's work to launch it stays off the clock; the median of
    ``iters`` calls after a warm-up.  Needs no profiler."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(LM_QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2]


def _host_gb() -> tuple:
    """(this process's resident GB, the host's available GB), from
    /proc."""
    def field(path, key):
        for line in Path(path).read_text().splitlines():
            if line.startswith(key):
                return int(line.split()[1]) * 1024 / 1e9
        return float("nan")
    return (field("/proc/self/status", "VmRSS:"),
            field("/proc/meminfo", "MemAvailable:"))


def _free_gb(torch) -> tuple:
    """(free device GB, GB the caching allocator reserves)."""
    return (torch.cuda.mem_get_info()[0] / 1e9,
            torch.cuda.memory_reserved() / 1e9)


def lm_time_table(torch, grads_k, card: str) -> dict:
    """K1 and K2 timed on the LM table (one launch each, 14 leaves x 5
    clients, bf16), as the step calls them (K2 without masks): CUDA-event
    ms a call beside the plain version (in turns); the device ms of one
    launch by CUDA events with the queue held ahead (``queued_ms``); and
    profiler device µs, its window opened after the caching allocator
    hands its free blocks back (the device's free memory logged before
    it).  The 6.3 GB table is over a hundred times the 50 MB L2, so each
    call meets it in HBM and no flush is needed.  Byte bounds: K1 reads
    every entry once (2 B); K2 reads it and writes its masked value (4 B
    an entry).  K2 with masks (the medical path's mode, 1 B more an entry)
    is timed beside it for the record."""
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    *_, table = _lm_table(torch, grads_k)
    mats = [leaf[0] for leaf in table]
    entries = sum(m.numel() for m in mats)
    # K1 writes row and column norms a slot; K2 reads the shared zero rows,
    # a column score a slot, a threshold a slot and rest, and writes a
    # count a (leaf, slot)
    norms_f32 = 4 * sum(m.shape[0] * (m.shape[1] + m.shape[2]) for m in mats)
    operands = 4 * sum(m.shape[1] + m.shape[0] * m.shape[2] for m in mats) \
        + 4 * LM_CLIENTS + 4 + 4 * len(mats) * LM_CLIENTS
    units = {
        "channel_norm": (lambda: [cn.channel_norms_plain(m) for m in mats],
                         lambda: cn.channel_norms_leaves(mats),
                         ("channel_norms_kernel",),
                         2 * entries + norms_f32, 3 * entries),
        "select_mask": (lambda: [sm.select_mask_plain(*leaf)
                                 for leaf in table],
                        lambda: sm.select_mask_leaves(table, masks=False),
                        ("select_mask_kernel",),
                        4 * entries + operands, 3 * entries),
    }
    out = {}
    for name, (plain, kernel, names, nbytes, flops) in units.items():
        p1, k1, k2, p2 = (cuda_ms(f, iters=5, warmup=1)
                          for f in (plain, kernel, kernel, plain))
        bound, by = bound_ms(nbytes, flops)
        queued = queued_ms(torch, kernel)
        torch.cuda.empty_cache()
        free, reserved = _free_gb(torch)
        dev = device_us(torch, kernel, names, 1, iters=5)[0]
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "queued_ms": queued, "device_us": dev,
                     "free_gb_before_profile": free,
                     "reserved_gb_before_profile": reserved,
                     "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                     "entries": entries, "leaves": len(mats),
                     "slots": LM_CLIENTS}
        if name == "select_mask":
            masked = lambda: sm.select_mask_leaves(table)
            out[name]["with_masks_queued_ms"] = queued_ms(torch, masked)
        log(f"lm: {name} on the LM table ({len(mats)} leaves x "
            f"{LM_CLIENTS} clients, {entries:,} bf16 entries): one launch "
            f"{queued:.4f} ms by events ({bound / queued:.1%} of the bound), "
            f"profiler device {dev} µs (free {free:.1f} GB, reserved "
            f"{reserved:.1f} GB before the window), {out[name]['ms']:.3f} ms "
            f"a call, plain {out[name]['plain_ms']:.3f} ms; bound "
            f"{bound:.3f} ms ({by}, {nbytes / 1e9:.2f} GB)"
            + (f"; with masks {out[name]['with_masks_queued_ms']:.4f} ms"
               if name == "select_mask" else "") + f" ({card})")
    return out


def lm_profile(torch, bundle, params, step, batch, card: str) -> dict:
    """Where the LM's time goes: torch.profiler over 3 steady decode steps
    (batch 4 against a cache of 128 holding a 32-token prompt) and over
    one steady federated step (its kernel events must show K1 and K2 once
    each): wall, device busy share, device events and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    sv = LM_SERVE
    prompts = torch.randint(0, bundle.cfg.vocab_size,
                            (sv["batch"], sv["prompt"]), dtype=torch.int32,
                            device="cuda")
    logits, caches = bundle.prefill_step(params, {
        "tokens": prompts, "caches": bundle.make_cache(sv["batch"],
                                                       sv["cache"])})
    token = torch.argmax(logits, -1)[:, None].to(torch.int32)

    def decode3():
        nonlocal caches, token
        for t in range(3):
            pos = torch.full((sv["batch"], 1), sv["prompt"] + t,
                             dtype=torch.int32, device="cuda")
            lg, caches = bundle.decode_step(params, {
                "token": token, "pos": pos, "caches": caches})
            token = torch.argmax(lg, -1)[:, None].to(torch.int32)

    out = {}
    torch.cuda.empty_cache()
    for what, fn in (("3 decode steps", decode3),
                     ("1 federated step", lambda: step(params, batch))):
        free, reserved = _free_gb(torch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = _device_events(prof)
        if not by_name:
            raise AssertionError(f"lm: the profile of {what} holds no CUDA "
                                 f"event (free {free:.1f} GB, reserved "
                                 f"{reserved:.1f} GB before it)")
        out[what] = {**_window(by_name, wall), "free_gb_before": free,
                     "reserved_gb_before": reserved}
        log(f"lm: profile of {what}: " + json.dumps({**out[what],
                                                    "card": card}))
    fed = out["1 federated step"]
    if (fed["kernel_launches"]["channel_norm"],
            fed["kernel_launches"]["select_mask"]) != (1, 1):
        raise AssertionError(f"lm: a profiled federated step launched "
                             f"{fed['kernel_launches']}")
    return out


def phase_lm(torch, card: str) -> dict:
    """qwen2-0.5b at full width, bf16, weights drawn on the card from a
    seed: serving, then LM_STEPS federated SCBF steps through
    ``make_federated_train_step`` (K1 and K2 once a step, asserted from
    the wrapper counts), the step's own table against the plain versions,
    and K1 and K2 timed on it.  Returns the launches and the timings."""
    from repro_torch import configs
    from repro_torch.config import ScbfConfig
    from repro_torch.core import channels as ch
    from repro_torch.core.distributed import make_federated_train_step
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models import model_zoo
    from repro_torch.params import tree_leaves

    cfg = configs.get(LM_ARCH)
    t0 = time.perf_counter()
    bundle = model_zoo.build(cfg, device="cuda")
    params, _ = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    if n != cfg.param_count():
        raise AssertionError(f"lm: {n} params, want {cfg.param_count()}")
    log(f"lm: {cfg.name} ({cfg.num_layers}L d={cfg.d_model} {cfg.num_heads}"
        f"H/{cfg.num_kv_heads}KV d_ff={cfg.d_ff} vocab={cfg.vocab_size}, "
        f"{cfg.dtype}, {n:,} params) drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    out = {"serve": lm_serve(torch, bundle, params, card)}

    scbf = ScbfConfig(upload_rate=LM_RATE, num_clients=LM_CLIENTS)
    step = make_federated_train_step(bundle.loss_fn, scbf, lr=LM_LR)
    stream = SyntheticTokenStream(LM_CLIENTS * LM_BATCH, LM_SEQ,
                                  cfg.vocab_size, seed=0)
    seen = {}
    real = ch.apply_factored_mask_slots

    def tap(grads_k, rate, selection, in_place=False):
        # out of place, so that the checks see the step's g beside its g̃
        # (the step masks in place; its values are the same either way)
        masked, frac = real(grads_k, rate, selection)
        seen.update(grads=grads_k, masked=masked, frac=frac)
        return masked, frac

    ch.apply_factored_mask_slots = tap
    losses, walls, counts = [], [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, nb in zip(range(LM_STEPS), stream):
            batch = {k: torch.from_numpy(v).cuda().reshape(
                LM_CLIENTS, LM_BATCH, LM_SEQ) for k, v in nb.items()}
            torch.cuda.synchronize()
            _reset_launches()
            t1 = time.perf_counter()
            loss, params = step(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            counts.append(_launch_counts())
            losses.append(float(loss))
    finally:
        ch.apply_factored_mask_slots = real
    peak = _peak_gb(torch)
    for c in counts:
        if (c["channel_norm"], c["select_mask"]) != (1, 1) or any(
                c[k] for k in c if k not in ("channel_norm", "select_mask")):
            raise AssertionError(f"lm: a federated step launched {c}; want "
                                 f"K1 and K2 once each and nothing else")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"lm: losses {losses}")
    masked = tree_leaves(seen["masked"])
    checks = lm_table_checks(torch, seen["grads"], masked, seen["frac"])
    log(f"lm: {LM_STEPS} federated steps ({LM_CLIENTS} clients x "
        f"{LM_BATCH} x {LM_SEQ} tokens, rate {LM_RATE}, lr {LM_LR}): losses "
        f"{losses}, step walls {[round(w, 4) for w in walls]} s, peak "
        f"{peak:.2f} GB; K1 and K2 once a step ({checks['leaves']} leaves x "
        f"{checks['slots']} slots, one table); kept fraction a client "
        f"{checks['kept_fraction']}; on the last step's table K1 within "
        f"rtol {LM_K1_RTOL} and no absolute floor (max rel err "
        f"{checks['k1_max_rel_err']:.3g}; thresholds "
        f"{checks['threshold']}, plain {checks['plain_threshold']}; median "
        f"score {checks['median_score']}, unembedding's "
        f"{checks['unembed_median_score']:.3g}; {checks['channel_flips']} "
        f"channels flipped against the plain scores, all at the "
        f"threshold) and K2 bitwise (values, masks, counts; and without "
        f"masks, as the step calls it) of their plain versions ({card})")
    timing = lm_time_table(torch, seen["grads"], card)
    del seen
    profiles = lm_profile(torch, bundle, params, step, batch, card)
    out.update(losses=losses, step_walls=walls, peak_gb=peak,
               checks=checks, timing=timing, profiles=profiles,
               launches={"channel_norm": sum(c["channel_norm"]
                                             for c in counts),
                         "select_mask": sum(c["select_mask"]
                                            for c in counts)})
    return out


# the lm-moe phase: llama4-maverick and deepseek-v2 at every published
# width, cut to one period of their layer pattern (depth 2), bf16, random
# weights from a seed
MOE_DEPTH = 2
MOE_LLAMA = "llama4-maverick-400b-a17b"
MOE_LLAMA_SERVE = dict(batch=4, prompt=32, gen=8, cache=128)
MOE_DEEPSEEK = "deepseek-v2-236b"
MOE_SERVE = dict(batch=4, prompt=32, gen=32, cache=128)
# K = 2 clients (the launcher's 5 would need 5 x 10.71 GB of gradient
# buffers), each 4 sequences of 64 tokens; 4 steps: the first cold, the
# second steady, the third profiled, the last checked
MOE_CLIENTS, MOE_STEPS = 2, 4
MOE_TABLES = 3                        # two bf16 leaf tables and one fp32
MOE_PEAK_GB = 60.0                    # the step's peak device memory
MOE_BIG_ROWS = 1 << 16                # rows a plain block of the K2 split


class RouteTap:
    """Counts what ``models.moe._route`` routes while it is on: the
    (token, expert) assignments each expert received (before capacity)
    and those dropped past it, summed over the calls; with ``keep``, each
    call's router probabilities (T, E) too.  A tap of the port's routing
    (the real ``_route`` computes every table)."""

    def __init__(self, torch, num_experts: int, keep: bool = False):
        from repro_torch.models import moe
        self.torch, self.moe = torch, moe
        self.load = torch.zeros(num_experts, dtype=torch.int64,
                                device="cuda")
        self.routed = self.kept = self.calls = 0
        self.capacities = set()
        self.probs = [] if keep else None

    def __enter__(self):
        # what is there now: taps nest, each calling the one it wraps
        torch, real = self.torch, self.moe._route
        self.real = real

        def route(probs, k, capacity):
            table, gate = real(probs, k, capacity)
            eidx = torch.topk(probs, k, axis=-1).indices
            self.load += torch.bincount(eidx.reshape(-1),
                                        minlength=self.load.numel())
            self.routed += eidx.numel()
            self.kept += int(torch.count_nonzero(table < probs.shape[1]))
            self.calls += 1
            self.capacities.add(capacity)
            if self.probs is not None:
                self.probs.append(probs.reshape(-1, probs.shape[-1]).clone())
            return table, gate

        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real

    @property
    def dropped(self) -> int:
        return self.routed - self.kept

    def summary(self) -> dict:
        load = self.load.cpu()
        return {"calls": self.calls, "routed": self.routed,
                "dropped": self.dropped,
                "capacities": sorted(self.capacities),
                "tokens_per_expert_min_mean_max": [
                    int(load.min()), float(load.float().mean()),
                    int(load.max())],
                "experts_receiving_none": int((load == 0).sum())}


def _moe_model(torch, arch: str, card: str):
    """(cfg, bundle, params) of ``arch`` at depth MOE_DEPTH, every width
    as published, bf16, drawn on the card from seed 0."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model_zoo
    from repro_torch.params import tree_leaves

    cfg = dataclasses.replace(configs.get(arch), num_layers=MOE_DEPTH)
    t0 = time.perf_counter()
    bundle = model_zoo.build(cfg, device="cuda")
    params, _ = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    if n != cfg.param_count():
        raise AssertionError(f"lm-moe: {n} params, want "
                             f"{cfg.param_count()}")
    log(f"lm-moe: {cfg.name} at depth {MOE_DEPTH} (d={cfg.d_model} "
        f"{cfg.num_heads}H/{cfg.num_kv_heads}KV, {cfg.num_experts} experts "
        f"top-{cfg.experts_per_token} + {cfg.num_shared_experts} shared, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, MLA {cfg.use_mla}; "
        f"{n:,} params, {gb:.2f} GB, "
        f"{sum(t.dtype == torch.float32 for t in leaves)} fp32 leaf) "
        f"drawn on the card in {time.perf_counter() - t0:.2f}s ({card})")
    return cfg, bundle, params


def moe_serve(torch, bundle, params, sv: dict, card: str,
              tag: str = "lm-moe") -> dict:
    """A warm-up call, the timed batch through ``launch.serve.generate``
    at the published capacity factor, and the same batch again under a
    ``RouteTap`` (the tokens each expert received, the dropped ones)."""
    from repro_torch.launch.serve import generate

    cfg = bundle.cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (sv["batch"], sv["prompt"]),
                            generator=gen, dtype=torch.int32, device="cuda")
    generate(bundle, params, prompts, 2, sv["cache"])          # warm-up
    torch.cuda.reset_peak_memory_stats()
    res = generate(bundle, params, prompts, sv["gen"], sv["cache"])
    toks = res.tokens
    if not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"{tag}: token ids outside [0, "
                             f"{cfg.vocab_size})")
    decoded = sv["batch"] * (sv["gen"] - 1)
    out = {"prefill_ms": res.prefill_s * 1e3,
           "decode_ms": res.decode_s * 1e3,
           "decode_ms_a_step": res.decode_s * 1e3 / (sv["gen"] - 1),
           "decode_tok_s": decoded / res.decode_s,
           "peak_gb": _peak_gb(torch)}
    with RouteTap(torch, cfg.num_experts) as tap:
        generate(bundle, params, prompts, sv["gen"], sv["cache"])
    out["routing"] = tap.summary()
    log(f"{tag}: serve {cfg.name} batch {sv['batch']} prompt "
        f"{sv['prompt']} gen {sv['gen']} cache {sv['cache']} at capacity "
        f"factor {cfg.moe_capacity_factor}: prefill {out['prefill_ms']:.2f}"
        f" ms, decode {out['decode_ms']:.1f} ms ({out['decode_ms_a_step']:.2f}"
        f" ms a step, {out['decode_tok_s']:.1f} tok/s), peak "
        f"{out['peak_gb']:.2f} GB; routing of the same batch: "
        + json.dumps(out["routing"]) + f" ({card})")
    return out


def moe_k2_split_check(torch, params, card: str) -> dict:
    """K2 on one bf16 matrix past 2^31 entries: llama4's expert stack
    ``wi`` as (128 x 5120, 8192) = 5,368,709,120 entries, random row and
    column scores, masked by one launch (the wrapper's three row blocks)
    into a new buffer, without masks; held bitwise against the plain
    version a block of MOE_BIG_ROWS rows at a time, values and count."""
    from repro_torch.kernels import select_mask as sm

    g = params["stack"]["l1"]["moe"]["wi"]
    g = g.reshape(-1, g.shape[-1])
    m, n = g.shape
    if m * n < sm.MAX_ENTRIES:
        raise AssertionError(f"lm-moe: {m} x {n} is not past 2^31")
    gen = torch.Generator(device="cuda").manual_seed(7)
    row = torch.rand(m, generator=gen, device="cuda")
    col = torch.rand(n, generator=gen, device="cuda")
    thr = torch.full((), 1.0, device="cuda")
    rest = torch.zeros((), device="cuda")
    before = sm.mask_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (out,), _, counts = sm.select_mask_leaves([(g, row, col, thr, rest)],
                                              masks=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sm.mask_launches - before
    total = 0
    for a in range(0, m, MOE_BIG_ROWS):
        b = min(m, a + MOE_BIG_ROWS)
        pout, _, pcnt = sm.select_mask_plain(g[a:b], row[a:b], col, thr,
                                             rest)
        if not torch.equal(out[a:b], pout):
            raise AssertionError(f"lm-moe: K2 past 2^31 differs from plain "
                                 f"in rows {a}:{b}")
        total += int(pcnt)
    if int(counts[0]) != total or launches != 1:
        raise AssertionError(f"lm-moe: K2 past 2^31 counted "
                             f"{int(counts[0])} (plain {total}) in "
                             f"{launches} launches")
    del out
    res = {"entries": m * n, "blocks": -(-m // ((sm.MAX_ENTRIES - 1) // n)),
           "launches": launches, "kept": total, "wall_ms": wall * 1e3}
    log(f"lm-moe: K2 on one bf16 matrix of {m} x {n} = {m * n:,} entries "
        f"(past 2^31): {res['blocks']} row blocks in {launches} launch, "
        f"bitwise the plain version (values and count, {total:,} kept), "
        f"{res['wall_ms']:.1f} ms ({card})")
    return res


def phase_llama4(torch, card: str) -> dict:
    """llama4-maverick at depth 2 ([dense, moe]), serving only: its single
    expert stack is too large a gradient for one card; then K2 past 2^31
    on that stack."""
    cfg, bundle, params = _moe_model(torch, MOE_LLAMA, card)
    out = {"serve": moe_serve(torch, bundle, params, MOE_LLAMA_SERVE, card)}
    if out["serve"]["routing"]["dropped"]:
        log(f"lm-moe: {cfg.name} dropped "
            f"{out['serve']['routing']['dropped']} assignments at 1.25")
    out["k2_past_2_31"] = moe_k2_split_check(torch, params, card)
    return out


def _drop_free(cfg):
    """A capacity factor under which no token drops at any T: C >= T."""
    import dataclasses
    return dataclasses.replace(
        cfg, moe_capacity_factor=float(math.ceil(cfg.num_experts
                                                 / cfg.experts_per_token)))


def _routing_flips(torch, dec, fwd, batch: int, prompt: int, n: int,
                   k: int) -> dict:
    """The MoE layer's routing at the n compared positions (prompt - 1
    ...), through the cache (``dec``: the prefill's probabilities, then one
    decode step's a call) against the cache-less forward (``fwd``): which
    (row, position) chose another top-k set of experts, the largest
    router log-probability difference between the two paths (δ), and
    each flip's gap between the k-th and (k+1)-th log-probabilities of
    the forward.  The MoE layer is the model's last, so a flip changes
    only its own position's logits."""
    E = fwd[0].shape[-1]
    ref = fwd[0].reshape(batch, -1, E)[:, prompt - 1:prompt - 1 + n]
    got = torch.stack([dec[0].reshape(batch, prompt, E)[:, -1]]
                      + [d.reshape(batch, E) for d in dec[1:n]], 1)
    lp_ref, lp_got = torch.log(ref), torch.log(got)
    delta = float((lp_got - lp_ref).abs().max())
    want = torch.sort(torch.topk(ref, k, axis=-1).indices, axis=-1).values
    have = torch.sort(torch.topk(got, k, axis=-1).indices, axis=-1).values
    flip = (want != have).any(-1)                           # (batch, n)
    top = torch.topk(lp_ref, k + 1, axis=-1).values
    gap = top[..., k - 1] - top[..., k]
    return {"flip": flip, "delta": delta, "gaps": [float(g) for g in
                                                   gap[flip].cpu()]}


def deepseek_consistency(torch, bundle, params, card: str) -> dict:
    """At a drop-free capacity (asserted: no assignment dropped): the
    first decode steps' logits against a cache-less forward over the same
    tokens, and a 1 x LM_LONG prefill (MLA's query-chunked path) against
    an unchunked forward (LM_LOGIT_MAX); then the same long prefill timed
    at the published capacity factor.  Decode against the forward: every
    (row, position) whose MoE routing chose the same experts in both
    paths within LM_LOGIT_MAX / LM_LOGIT_MEAN and with its greedy id
    equal; a row whose routing flipped (``_routing_flips``) only where its
    k-th and (k+1)-th router log-probabilities lie within 2δ, the two
    paths' largest router difference — a near-tie that bf16 rounding of
    the router's input may tip either way."""
    import dataclasses

    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo
    from repro_torch.models import transformer as T

    cfg = bundle.cfg
    free = model_zoo.build(_drop_free(cfg), device="cuda")
    sv = MOE_SERVE
    n = LM_DECODE_CHECKED + 1
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (sv["batch"], sv["prompt"]),
                            generator=gen, dtype=torch.int32, device="cuda")
    long = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen,
                         dtype=torch.int32, device="cuda")
    if not (LM_LONG > free.ctx.q_chunk and LM_LONG % free.ctx.q_chunk == 0):
        raise AssertionError("lm-moe: the long prefill must take the "
                             "chunked path")
    out = {"drop_free_factor": free.cfg.moe_capacity_factor}
    with RouteTap(torch, cfg.num_experts, keep=True) as dec, \
            RouteTap(torch, cfg.num_experts) as tap:
        res = generate(free, params, prompts, n, sv["cache"])
    seq = torch.cat([prompts, res.tokens[:, :n - 1]], axis=1)
    with RouteTap(torch, cfg.num_experts, keep=True) as fwd, tap:
        with torch.no_grad():
            h, _ = T.forward_hidden(params, free.cfg, seq, free.ctx)
            full = T.logits_from_hidden(params, free.cfg, h).float()
    with tap:
        lg, _ = free.prefill_step(params, {
            "tokens": long, "caches": free.make_cache(1, LM_LONG)})
        whole = dataclasses.replace(free.ctx, q_chunk=2 * LM_LONG)
        with torch.no_grad():
            h, _ = T.forward_hidden(params, free.cfg, long, whole)
            ref = T.logits_from_hidden(params, free.cfg, h[:, -1]).float()
    out["routing"] = tap.summary()
    if tap.dropped:
        raise AssertionError(f"lm-moe: {tap.dropped} assignments dropped "
                             f"at the drop-free factor")
    flips = _routing_flips(torch, dec.probs, fwd.probs, sv["batch"],
                           sv["prompt"], n, cfg.experts_per_token)
    same = ~flips["flip"]                                   # (batch, n)
    diffs = torch.stack([(res.logits[i].float()
                          - full[:, sv["prompt"] - 1 + i]).abs()
                         for i in range(n)], 1)             # (batch, n, V)
    greedy = torch.stack([torch.argmax(full[:, sv["prompt"] - 1 + i],
                                       -1).to(torch.int32) == res.tokens[:, i]
                          for i in range(n)], 1)            # (batch, n)
    out["routing_flips"] = int(flips["flip"].sum())
    out["flip_gaps"] = flips["gaps"]
    out["router_logprob_delta"] = flips["delta"]
    out["logit_max_abs"] = float(diffs[same].max())
    out["logit_mean_abs"] = max(float(diffs[:, i][same[:, i]].mean())
                                for i in range(n) if bool(same[:, i].any()))
    out["flipped_rows_logit_max_abs"] = float(diffs[~same].max()) \
        if out["routing_flips"] else None
    out["greedy_agree"] = int(greedy[same].sum())
    out["compared_rows"] = int(same.sum())
    out["long_max_abs"] = float((lg.float() - ref).abs().max())
    if not (out["logit_max_abs"] <= LM_LOGIT_MAX
            and out["logit_mean_abs"] <= LM_LOGIT_MEAN
            and out["greedy_agree"] == out["compared_rows"]
            and all(g <= 2 * flips["delta"] for g in flips["gaps"])
            and torch.isfinite(lg).all()
            and out["long_max_abs"] <= LM_LOGIT_MAX):
        raise AssertionError(f"lm-moe: decode or chunked prefill against "
                             f"the cache-less forward: {out}")
    with RouteTap(torch, cfg.num_experts) as tap:
        bundle.prefill_step(params, {"tokens": long,
                                     "caches": bundle.make_cache(1, LM_LONG)})
    out["long_routing"] = tap.summary()
    bundle.prefill_step(params, {"tokens": long,
                                 "caches": bundle.make_cache(1, LM_LONG)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, _ = bundle.prefill_step(params, {
        "tokens": long, "caches": bundle.make_cache(1, LM_LONG)})
    torch.cuda.synchronize()
    out["long_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(lg).all():
        raise AssertionError("lm-moe: the long prefill's logits")
    log(f"lm-moe: {cfg.name} at the drop-free capacity factor "
        f"{out['drop_free_factor']} (0 of {out['routing']['routed']} "
        f"assignments dropped): decode vs full forward over {n} positions "
        f"x {sv['batch']} rows: {out['routing_flips']} rows routed to "
        f"another top-{cfg.experts_per_token} (k-th vs (k+1)-th router "
        f"log-prob gaps {out['flip_gaps']}, within 2 x the paths' largest "
        f"router difference {out['router_logprob_delta']:.3g}; their max "
        f"|dlogit| {out['flipped_rows_logit_max_abs']}); the "
        f"{out['compared_rows']} others max |dlogit| "
        f"{out['logit_max_abs']:.4g}, mean {out['logit_mean_abs']:.3g}, "
        f"greedy ids equal at {out['greedy_agree']}; 1 x {LM_LONG} prefill "
        f"chunked by {free.ctx.q_chunk} vs unchunked max |dlogit| "
        f"{out['long_max_abs']:.4g}; at {cfg.moe_capacity_factor} the long "
        f"prefill takes {out['long_prefill_ms']:.1f} ms and drops "
        f"{out['long_routing']['dropped']} of "
        f"{out['long_routing']['routed']} ({card})")
    return out


class MoeStepTap:
    """One federated step's K1 and K2 calls as ``core.channels`` makes them
    (its module names wrapped, the real wrappers called, so the counts
    are the step's): each K1 table's scores held against the plain
    version on the device before K2 masks the table (rtol LM_K1_RTOL, no
    absolute floor), the table's g copied to the host; each K2 table
    (masked in place) held bitwise against the plain version on that
    copy, slot by slot, values and counts.  ``clients`` slots a leaf;
    ``tag`` heads its messages."""

    def __init__(self, torch, clients: int = MOE_CLIENTS,
                 tag: str = "lm-moe"):
        from repro_torch.core import channels as ch
        self.torch, self.ch = torch, ch
        self.clients, self.tag = clients, tag
        self.real_k1, self.real_k2 = ch.channel_norms_leaves, \
            ch.select_mask_leaves
        self.real_mask = ch.apply_factored_mask_slots
        self.frac = None
        self.host, self.kcols, self.pcols, self.tables = [], [], [], []
        self.pending = []
        self.k1_rel = 0.0
        self.k2_tables = 0

    def __enter__(self):
        self.ch.channel_norms_leaves = self.k1
        self.ch.select_mask_leaves = self.k2
        self.ch.apply_factored_mask_slots = self.mask
        return self

    def __exit__(self, *exc):
        self.ch.channel_norms_leaves = self.real_k1
        self.ch.select_mask_leaves = self.real_k2
        self.ch.apply_factored_mask_slots = self.real_mask

    def mask(self, *args, **kw):
        masked, frac = self.real_mask(*args, **kw)
        self.frac = [float(f) for f in frac.cpu()]
        return masked, frac

    def k1(self, gs):
        from repro_torch.kernels import channel_norm as cn
        torch = self.torch
        out = self.real_k1(gs)
        copies = []
        for g, (_, col) in zip(gs, out):
            for s in range(g.shape[0]):
                _, pcol = cn.channel_norms_plain(g[s])
                torch.testing.assert_close(col[s], pcol, rtol=LM_K1_RTOL,
                                           atol=0.0)
                self.k1_rel = max(self.k1_rel, float(
                    ((col[s] - pcol).abs()
                     / pcol.abs().clamp_min(1e-38)).max()))
                self.pcols.append(pcol)
                self.kcols.append(col[s].clone())
            copies.append(g.cpu())
        self.tables.append([(tuple(g.shape), str(g.dtype)) for g in gs])
        self.pending.append(copies)
        return out

    def k2(self, table, masks=True, out=None):
        from repro_torch.kernels import select_mask as sm
        torch = self.torch
        outs, made, counts = self.real_k2(table, masks=masks, out=out)
        copies = self.pending.pop(0)
        self.host.append(copies)
        slots = table[0][0].shape[0]
        for j, (leaf, o, orig) in enumerate(zip(table, outs, copies)):
            if tuple(orig.shape) != tuple(o.shape):
                raise AssertionError(f"{self.tag}: K1's and K2's tables "
                                     f"differ")
            for s in range(slots):
                _, row, col, thr, rest = sm.leaf_slot(leaf, s)
                pout, _, pcnt = sm.select_mask_plain(orig[s].cuda(), row,
                                                     col, thr, rest)
                if not (torch.equal(o[s], pout) and
                        int(counts[j * slots + s]) == int(pcnt)):
                    raise AssertionError(
                        f"{self.tag}: K2 differs from plain on table "
                        f"{self.k2_tables} leaf {j} slot {s} "
                        f"{tuple(o.shape)}")
                del pout
        self.k2_tables += 1
        return outs, made, counts

    def flips(self, rate: float) -> dict:
        """The channels kept by K1's scores and their threshold against
        those kept by the plain scores and theirs: a flip is allowed only
        where the plain score ties the plain threshold within 2 x
        LM_K1_RTOL."""
        torch, ch = self.torch, self.ch
        # one pool a client: the scores are (leaf, slot) in order
        k = self.clients
        kc = [torch.stack(self.kcols[i:i + k]) for i in
              range(0, len(self.kcols), k)]
        pc = [torch.stack(self.pcols[i:i + k]) for i in
              range(0, len(self.pcols), k)]
        thr = ch.factored_threshold(kc, rate)
        pthr = ch.factored_threshold(pc, rate)
        flips = 0
        for a, b in zip(kc, pc):
            diff = (a >= thr[:, None]) != (b >= pthr[:, None])
            tie = (b - pthr[:, None]).abs() <= \
                2 * LM_K1_RTOL * pthr.abs()[:, None]
            if bool(torch.any(diff & ~tie)):
                raise AssertionError(f"{self.tag}: K1's scores keep other "
                                     "channels than the plain scores do, "
                                     "away from the threshold")
            flips += int(torch.count_nonzero(diff))
        return {"threshold": [float(t) for t in thr.cpu()],
                "plain_threshold": [float(t) for t in pthr.cpu()],
                "channel_flips": flips}


def moe_time_tables(torch, host, card: str, tag: str = "lm-moe") -> dict:
    """K1 and K2 timed on each of the step's leaf tables, rebuilt on the
    card from the tap's host copies one table at a time, as the step
    calls them (K2 in place, without masks): CUDA-event ms a call beside
    the plain version (in turns) and the device ms of one launch with
    the queue held ahead (``queued_ms``), each against its byte bound (K1
    reads every entry once and writes the row and column norms; K2 reads
    it and writes it back)."""
    from repro_torch.core import channels as ch
    from repro_torch.kernels import channel_norm as cn
    from repro_torch.kernels import select_mask as sm

    out = {"channel_norm": [], "select_mask": []}
    for t, copies in enumerate(host):
        mats = [c.cuda() for c in copies]
        k = mats[0].shape[0]
        item = mats[0].element_size()
        entries = sum(m.numel() for m in mats)
        _, scores = zip(*cn.channel_norms_leaves(mats))
        thr = ch.factored_threshold(list(scores), LM_RATE)
        below = torch.nextafter(thr, torch.full_like(thr, float("-inf")))
        rest = torch.zeros((), device="cuda")
        table = [(m, torch.zeros(m.shape[1], device="cuda"), s, below, rest)
                 for m, s in zip(mats, scores)]
        norms_f32 = 4 * sum(m.shape[0] * (m.shape[1] + m.shape[2])
                            for m in mats)
        operands = 4 * sum(m.shape[1] + m.shape[0] * m.shape[2]
                           for m in mats) + 4 * k + 4 + 4 * len(mats) * k
        units = {
            "channel_norm": (
                lambda: [cn.channel_norms_plain(m) for m in mats],
                lambda: cn.channel_norms_leaves(mats),
                item * entries + norms_f32, 3 * entries),
            "select_mask": (
                lambda: [sm.select_mask_plain(*leaf, out=leaf[0])
                         for leaf in table],
                lambda: sm.select_mask_leaves(table, masks=False,
                                              out=mats),
                2 * item * entries + operands, 3 * entries),
        }
        for name, (plain, kernel, nbytes, flops) in units.items():
            p1, k1, k2, p2 = (cuda_ms(f, iters=3, warmup=1)
                              for f in (plain, kernel, kernel, plain))
            bound, by = bound_ms(nbytes, flops)
            queued = queued_ms(torch, kernel, iters=5)
            row = {"table": t, "leaves": len(mats), "slots": k,
                   "dtype": str(mats[0].dtype), "entries": entries,
                   "bytes": nbytes, "ms": (k1 + k2) / 2,
                   "plain_ms": (p1 + p2) / 2, "queued_ms": queued,
                   "bound_ms": bound, "bound_by": by}
            out[name].append(row)
            log(f"{tag}: {name} on leaf table {t} ({len(mats)} leaves x "
                f"{k} clients, {entries:,} {mats[0].dtype} entries): one "
                f"launch {queued:.4f} ms by events ({bound / queued:.1%} of "
                f"the bound), {row['ms']:.3f} ms a call, plain "
                f"{row['plain_ms']:.3f} ms; bound {bound:.4f} ms ({by}, "
                f"{nbytes / 1e9:.3f} GB) ({card})")
        del mats, table, scores
        torch.cuda.empty_cache()
    return out


def phase_deepseek(torch, card: str) -> dict:
    """deepseek-v2 at depth 2 (the dense prefix layer + one MoE layer):
    serving at 1.25, the drop-free consistency checks, then MOE_STEPS
    federated SCBF steps (K1 and K2 once a leaf table a step, from the
    wrapper counts; the peak memory under MOE_PEAK_GB; the next to last
    step profiled, the last one's tables checked against the plain
    versions), and K1 and K2 timed on those tables."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ScbfConfig
    from repro_torch.core import distributed as dist
    from repro_torch.data.tokens import SyntheticTokenStream

    cfg, bundle, params = _moe_model(torch, MOE_DEEPSEEK, card)
    out = {"serve": moe_serve(torch, bundle, params, MOE_SERVE, card),
           "consistency": deepseek_consistency(torch, bundle, params, card)}
    torch.cuda.empty_cache()

    scbf = ScbfConfig(upload_rate=LM_RATE, num_clients=MOE_CLIENTS)
    step = dist.make_federated_train_step(bundle.loss_fn, scbf, lr=LM_LR)
    stream = SyntheticTokenStream(MOE_CLIENTS * LM_BATCH, LM_SEQ,
                                  cfg.vocab_size, seed=0)
    losses, walls, counts, peaks, grad_peaks = [], [], [], [], []
    tap = MoeStepTap(torch)
    profiled = None
    real_grads = dist.client_gradients

    def client_gradients(*args):
        # the peak so far in the step: the gradient phase's
        out = real_grads(*args)
        grad_peaks.append(_peak_gb(torch))
        return out

    dist.client_gradients = client_gradients
    try:
        for i, nb in zip(range(MOE_STEPS), stream):
            batch = {k: torch.from_numpy(v).cuda().reshape(
                MOE_CLIENTS, LM_BATCH, LM_SEQ) for k, v in nb.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t1 = time.perf_counter()
            if i == MOE_STEPS - 2:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    loss, params = step(params, batch)
                    torch.cuda.synchronize()
                profiled = prof
            elif i == MOE_STEPS - 1:
                with tap:
                    loss, params = step(params, batch)
            else:
                loss, params = step(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            counts.append(_launch_counts())
            peaks.append(_peak_gb(torch))
            losses.append(float(loss))
    finally:
        dist.client_gradients = real_grads
    for c in counts:
        if (c["channel_norm"], c["select_mask"]) != (MOE_TABLES,
                                                     MOE_TABLES) or any(
                c[k] for k in c if k not in ("channel_norm", "select_mask")):
            raise AssertionError(f"lm-moe: a federated step launched {c}; "
                                 f"want K1 and K2 once a leaf table "
                                 f"({MOE_TABLES}) and nothing else")
    if tap.k2_tables != MOE_TABLES or len(tap.tables) != MOE_TABLES:
        raise AssertionError(f"lm-moe: the tapped step checked "
                             f"{tap.k2_tables} tables")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"lm-moe: losses {losses}")
    if max(peaks) >= MOE_PEAK_GB:
        raise AssertionError(f"lm-moe: a step's peak {peaks} GB is not "
                             f"under {MOE_PEAK_GB} GB")
    by_name = _device_events(profiled)
    if not by_name:
        raise AssertionError("lm-moe: the profiled step holds no CUDA event")
    window = _window(by_name, walls[-2])
    flips = tap.flips(LM_RATE)
    log(f"lm-moe: {MOE_STEPS} federated steps of {cfg.name} "
        f"({MOE_CLIENTS} clients x {LM_BATCH} x {LM_SEQ} tokens, rate "
        f"{LM_RATE}, lr {LM_LR}): losses {losses}, step walls "
        f"{[round(w, 4) for w in walls]} s (step 1 cold, step 2 steady, "
        f"step 3 profiled, step 4 checked), peaks "
        f"{[round(p, 2) for p in peaks]} GB (under {MOE_PEAK_GB} GB; the "
        f"checked step's checks add to its own), the gradient phase's "
        f"{[round(p, 2) for p in grad_peaks]} GB; K1 "
        f"and K2 once a leaf table a step ({MOE_TABLES} each): tables "
        + json.dumps(tap.tables) + f"; kept fraction a client {tap.frac}; "
        f"on step {MOE_STEPS}'s tables K1 within rtol "
        f"{LM_K1_RTOL} and no absolute floor (max rel err "
        f"{tap.k1_rel:.3g}; thresholds {flips['threshold']}, plain "
        f"{flips['plain_threshold']}; {flips['channel_flips']} channels "
        f"flipped, all at the threshold) and K2 in place bitwise its plain "
        f"version (values and counts) ({card})")
    log("lm-moe: profile of 1 federated step: "
        + json.dumps({**window, "card": card}))
    out.update(losses=losses, step_walls=walls, peaks_gb=peaks,
               gradient_phase_peaks_gb=grad_peaks, kept_fraction=tap.frac,
               profile=window, k1_max_rel_err=tap.k1_rel, flips=flips,
               tables=tap.tables,
               launches={k: sum(c[k] for c in counts)
                         for k in ("channel_norm", "select_mask")})
    host = tap.host
    del tap, params, bundle
    torch.cuda.empty_cache()
    out["timing"] = moe_time_tables(torch, host, card)
    return out


def phase_lm_moe(torch, card: str) -> dict:
    """llama4-maverick, then deepseek-v2, each freed before the next."""
    torch.cuda.empty_cache()
    llama = phase_llama4(torch, card)
    torch.cuda.empty_cache()
    deepseek = phase_deepseek(torch, card)
    torch.cuda.empty_cache()
    return {"llama4": llama, "deepseek": deepseek,
            "launches": deepseek["launches"], "timing": deepseek["timing"]}


# the lm-ssm phase: mamba2-2.7b uncut and one period of jamba-1.5-large at
# the published widths, bf16, random weights from a seed
SSM_ARCH = "mamba2-2.7b"
SSM_SERVE = dict(batch=4, prompt=32, gen=32, cache=128)
SSM_STEPS = 3                         # long and cold, profiled, checked
SSM_LONG_SEQ = 512                    # the first step: 2 SSD chunks of 256
SSM_CLIENTS = 2                       # of LM_CLIENTS: the command's time
SSM_LONG_CLIENTS = 1                  # of LM_CLIENTS: the command's time
SSM_TABLES = 2                        # a bf16 leaf table and an fp32 one
# a profiled selection's window opens with a burst of this many
# one-element kernels of its own (``bitwise_not``), left out of its
# numbers: right after a client's gradient phase (hundreds of thousands of
# unprofiled launches) the profiler loses a window's first events — on the
# H100, 12 of 12 windows opened without a burst (as here but for it,
# without the warm-up step, or with device activity only) lost their first
# 0.7 s, K1 among them, and 4 of 4 opened with a burst of 20,000 lost
# none; a host idle of 1 s (the earlier opening) lost K1 in 3 of 3 windows
# of one whole command
SELECTION_BURST = 20_000
SELECTION_BURST_KERNEL = "bitwise_not_kernel"
SELECTION_IDLE_S = 0.2                # host idle after the burst
SSM_PEAK_GB = 60.0
# mamba2's decode against a cache-less forward.  In fp32 at full width the
# two paths agree to 1.37e-4 max / 2.0e-5 mean |dlogit| (H100 run, greedy
# ids equal), so the gate there is the algorithm's.  In bf16 every one of
# the 64 layers rounds its output and the residual stream, and the two
# paths round different sums: 0.357 max / 0.058 mean in the same run, past
# LM_LOGIT_MAX / LM_LOGIT_MEAN; two bf16 forwards that differ only in the
# SSD's chunking (4 chunks of 256 against one of 1024) differ by 0.398 on
# one prompt.  So bf16 is held to that noise, with room, and its greedy
# ids to the forward's but at a near-tie of the top two logits.
SSM_FP32_LOGIT_MAX, SSM_FP32_LOGIT_MEAN = 1e-3, 1e-4
SSM_LOGIT_MAX, SSM_LOGIT_MEAN = 1.0, 0.15
JAMBA_ARCH = "jamba-1.5-large-398b"
# one period of jamba's pattern (7 Mamba layers, 1 attention; MoE every
# other layer) at the published widths holds 45.1 G params, 90.3 GB in
# bf16, more than the card's 80 GB: 8 of its 16 experts (top-2 kept) make
# it 25.8 G, 51.6 GB
JAMBA_CUT = dict(num_layers=8, num_experts=8)
JAMBA_SERVE = dict(batch=4, prompt=32, gen=8, cache=128)


def _ssm_model(torch, arch: str, card: str, **cut):
    """(cfg, bundle, params) of ``arch`` at every published width with the
    ``cut`` fields replaced, drawn on the card from seed 0; the count is
    the meta-device tree's (``param_count()``, the reference's closed
    form, counts two norms a layer and no ``in_dt`` bias, so it is logged
    beside)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model_zoo
    from repro_torch.models import transformer as T
    from repro_torch.params import tree_leaves

    cfg = dataclasses.replace(configs.get(arch), **cut)
    before = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = model_zoo.build(cfg, device="cuda")
    params, _ = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    meta = sum(t.numel() for t in tree_leaves(T.init_model(cfg, None)[0]))
    if n != meta:
        raise AssertionError(f"lm-ssm: {n} params, the meta tree {meta}")
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    log(f"lm-ssm: {cfg.name} ({cfg.num_layers}L d={cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {cfg.num_ssm_heads} SSD heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}"
        f", {cfg.num_experts} experts top-{cfg.experts_per_token}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; cut: "
        f"{cut or 'none'}; {n:,} params (param_count() "
        f"{cfg.param_count():,}), {gb:.2f} GB, "
        f"{sum(t.dtype == torch.float32 for t in leaves)} fp32 leaves) "
        f"drawn on the card in {time.perf_counter() - t0:.2f}s (peak "
        f"{_peak_gb(torch):.2f} GB from {before:.2f} GB allocated before; "
        f"host {_host_gb()[0]:.1f} GB resident, {_host_gb()[1]:.1f} GB "
        f"available) ({card})")
    return cfg, bundle, params


def _chunk_difference(torch, bundle, params, long) -> float:
    """The largest |dlogit| of a prefill of ``long`` (1, L) at the model's
    SSD chunk against the same prefill as one chunk of L."""
    import dataclasses

    from repro_torch.models import model_zoo

    one = model_zoo.build(dataclasses.replace(bundle.cfg,
                                              ssm_chunk=long.shape[1]),
                          device="cuda")
    outs = [b.prefill_step(params, {"tokens": long,
                                    "caches": b.make_cache(1, long.shape[1])}
                           )[0].float() for b in (bundle, one)]
    return float((outs[0] - outs[1]).abs().max())


def ssm_serve(torch, bundle, params, card: str) -> dict:
    """mamba2 serving through ``launch.serve.generate`` (a warm-up call,
    the timed batch), its first decode steps (the O(1) recurrence over the
    conv window and the SSM state) against a cache-less forward (the
    chunked SSD); the same check in fp32 at full width as evidence beside
    the bf16 gate; and a 1 x LM_LONG prefill (4 SSD chunks through the
    inter-chunk loop) against the same prefill as one chunk, in bf16 and
    in fp32."""
    import dataclasses

    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo

    cfg = bundle.cfg
    sv = SSM_SERVE
    n = LM_DECODE_CHECKED + 1
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (sv["batch"], sv["prompt"]),
                            generator=gen, dtype=torch.int32, device="cuda")
    generate(bundle, params, prompts, 2, sv["cache"])          # warm-up
    torch.cuda.reset_peak_memory_stats()
    res = generate(bundle, params, prompts, sv["gen"], sv["cache"])
    if not (0 <= int(res.tokens.min())
            and int(res.tokens.max()) < cfg.vocab_size):
        raise AssertionError(f"lm-ssm: token ids outside [0, "
                             f"{cfg.vocab_size})")
    decoded = sv["batch"] * (sv["gen"] - 1)
    out = {"prefill_ms": res.prefill_s * 1e3,
           "decode_ms": res.decode_s * 1e3,
           "decode_ms_a_step": res.decode_s * 1e3 / (sv["gen"] - 1),
           "decode_tok_s": decoded / res.decode_s,
           "peak_gb": _peak_gb(torch),
           "bf16": _decode_vs_forward(torch, bundle, params, prompts, res,
                                      n)}
    # the same prompts in fp32: the weights are the same draws before
    # their rounding to bf16
    f32 = model_zoo.build(dataclasses.replace(cfg, dtype="float32"),
                          device="cuda")
    p32, _ = f32.init(torch.Generator(device="cuda").manual_seed(0))
    r32 = generate(f32, p32, prompts, n, sv["cache"])
    out["fp32"] = _decode_vs_forward(torch, f32, p32, prompts, r32, n)
    # one long prompt: LM_LONG / ssm_chunk chunks against one chunk
    long = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen,
                         dtype=torch.int32, device="cuda")
    if LM_LONG // cfg.ssm_chunk < 2 or LM_LONG % cfg.ssm_chunk:
        raise AssertionError("lm-ssm: the long prefill must take several "
                             "chunks")
    out["long_max_abs_fp32"] = _chunk_difference(torch, f32, p32, long)
    del f32, p32, r32
    torch.cuda.empty_cache()
    bundle.prefill_step(params, {"tokens": long,
                                 "caches": bundle.make_cache(1, LM_LONG)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, _ = bundle.prefill_step(params, {
        "tokens": long, "caches": bundle.make_cache(1, LM_LONG)})
    torch.cuda.synchronize()
    out["long_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["long_max_abs"] = _chunk_difference(torch, bundle, params, long)
    b16, f32 = out["bf16"], out["fp32"]
    if not (f32["logit_max_abs"] <= SSM_FP32_LOGIT_MAX
            and f32["logit_mean_abs"] <= SSM_FP32_LOGIT_MEAN
            and f32["greedy_agree"] == n
            and out["long_max_abs_fp32"] <= SSM_FP32_LOGIT_MAX
            and b16["logit_max_abs"] <= SSM_LOGIT_MAX
            and b16["logit_mean_abs"] <= SSM_LOGIT_MEAN
            and b16["greedy_off_tie"] == 0
            and torch.isfinite(lg).all()
            and out["long_max_abs"] <= SSM_LOGIT_MAX):
        raise AssertionError(f"lm-ssm: decode or the chunked prefill "
                             f"against the cache-less forward: {out}")
    log(f"lm-ssm: serve {cfg.name} batch {sv['batch']} prompt "
        f"{sv['prompt']} gen {sv['gen']}: prefill {out['prefill_ms']:.2f} "
        f"ms, decode {out['decode_ms']:.1f} ms ({out['decode_ms_a_step']:.2f}"
        f" ms a step, {out['decode_tok_s']:.1f} tok/s), peak "
        f"{out['peak_gb']:.2f} GB; decode vs full forward over {n} "
        f"positions: fp32 at full width max |dlogit| "
        f"{f32['logit_max_abs']:.4g}, mean {f32['logit_mean_abs']:.3g}, "
        f"greedy ids equal at {f32['greedy_agree']} of {n} (gate "
        f"{SSM_FP32_LOGIT_MAX} / {SSM_FP32_LOGIT_MEAN}); bf16 max |dlogit| "
        f"{b16['logit_max_abs']:.4g}, mean {b16['logit_mean_abs']:.3g}, "
        f"greedy ids equal at {b16['greedy_agree']} of {n}, "
        f"{b16['greedy_off_tie']} (row, position) pairs unequal away from "
        f"a near-tie (gate {SSM_LOGIT_MAX} / {SSM_LOGIT_MEAN}; the lm: "
        f"gate {LM_LOGIT_MAX} / {LM_LOGIT_MEAN}); 1 x {LM_LONG} prefill in "
        f"{LM_LONG // cfg.ssm_chunk} chunks of {cfg.ssm_chunk} "
        f"{out['long_prefill_ms']:.1f} ms, max |dlogit| vs one chunk of "
        f"{LM_LONG}: bf16 {out['long_max_abs']:.4g}, fp32 "
        f"{out['long_max_abs_fp32']:.4g} ({card})")
    return out


class SelectionProfile:
    """torch.profiler over the selection of each federated step run under
    it (the step's ``core.channels.apply_factored_mask_slots`` call, where
    K1 and K2 launch): each window's kernel events, wall and device busy
    share: a warm-up step and a burst of SELECTION_BURST kernels of its
    own open each window (after a gradient phase the profiler loses a
    window's first events), and its host idles WINDOW_TAIL_S times the
    window's number before it closes (late in the command the profiler
    has lost a window's last events)."""

    def __init__(self, torch):
        from repro_torch.core import channels as ch
        self.torch, self.ch = torch, ch
        self.windows = []

    def __enter__(self):
        self.real = self.ch.apply_factored_mask_slots
        self.ch.apply_factored_mask_slots = self.call
        return self

    def __exit__(self, *exc):
        self.ch.apply_factored_mask_slots = self.real

    def call(self, *args, **kw):
        from torch.profiler import ProfilerActivity, profile, schedule
        torch = self.torch
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1))
        # a warm-up step, and a burst of kernels of our own that the
        # window's lost first events fall on
        prof.start()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        burst = torch.zeros(1, dtype=torch.int32, device="cuda")
        for _ in range(SELECTION_BURST):
            burst.bitwise_not_()
        torch.cuda.synchronize()
        time.sleep(SELECTION_IDLE_S)
        t0 = time.perf_counter()
        out = self.real(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(WINDOW_TAIL_S * (len(self.windows) + 1))
        prof.stop()
        by_name = {k: v for k, v in _device_events(prof).items()
                   if SELECTION_BURST_KERNEL not in k}
        self.windows.append(_window(by_name, wall))
        launched = self.windows[-1]["kernel_launches"]
        if launched["channel_norm"] < SSM_TABLES:
            log(f"lm-ssm: a selection window with K1 "
                f"{launched['channel_norm']} and K2 {launched['select_mask']}"
                f" of {SSM_TABLES}: its CUDA events "
                + json.dumps({k[:50]: n for k, (n, _) in by_name.items()}))
        return out


def ssm_gradient_profile(torch, bundle, params, batch, card: str,
                         tag: str = "lm-ssm") -> dict:
    """torch.profiler (device activity only: a client's pass dispatches
    hundreds of thousands of kernels) over one client's forward and
    backward at the step's shape: wall, device busy share, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model_zoo

    one = {k: v[0] for k, v in batch.items()}
    model_zoo.value_and_grad(bundle.loss_fn, params, one)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model_zoo.value_and_grad(bundle.loss_fn, params, one)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    window = _window(_device_events(prof), wall)
    if not window["events"]:
        raise AssertionError(f"{tag}: the profile of a client's gradient "
                             "holds no CUDA event")
    log(f"{tag}: profile of one client's gradient of {bundle.cfg.name} "
        f"(4 x 64 tokens): " + json.dumps({**window, "card": card}))
    return window


def ssm_steps(torch, cfg, bundle, held: list, card: str) -> dict:
    """SSM_STEPS federated SCBF steps of mamba2, the first at
    SSM_LONG_CLIENTS x LM_BATCH x SSM_LONG_SEQ (2 SSD chunks of 256: a
    finite loss, every gradient leaf finite), the others of SSM_CLIENTS
    clients (K1 and K2 once a leaf table a step from the wrapper counts,
    and from the profiler in the first two steps' selections; the peak
    under SSM_PEAK_GB; the last step's tables against the plain versions
    through ``MoeStepTap``), a client's gradient profiled, and K1 and K2
    timed a table.  The
    selections of the untapped steps are profiled: no window may show
    more launches than the wrapper counts, and one at least all of
    them.  ``held``
    hands over the only reference to the params, so that a step's old
    params go once it returns its new ones."""
    from repro_torch.config import ScbfConfig
    from repro_torch.core import distributed as dist
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.kernels import select_mask as sm
    from repro_torch.params import tree_leaves

    params = held.pop()
    scbf = ScbfConfig(upload_rate=LM_RATE, num_clients=SSM_CLIENTS)
    step = dist.make_federated_train_step(bundle.loss_fn, scbf, lr=LM_LR)
    losses, walls, counts, peaks, grad_peaks = [], [], [], [], []
    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated() / 1e9
    tap = MoeStepTap(torch, SSM_CLIENTS, "lm-ssm")
    sel = SelectionProfile(torch)
    nonfinite = []
    real_grads = dist.client_gradients

    def client_gradients(*args):
        loss, grads = real_grads(*args)
        grad_peaks.append(_peak_gb(torch))
        nonfinite.append(sum(int(not torch.isfinite(g).all())
                             for g in tree_leaves(grads)))
        return loss, grads

    shapes = [(SSM_LONG_SEQ, 0, SSM_LONG_CLIENTS)] + \
        [(LM_SEQ, s, SSM_CLIENTS) for s in range(1, SSM_STEPS)]
    dist.client_gradients = client_gradients
    try:
        for i, (seq, seed, k) in enumerate(shapes):
            nb = synthetic_lm_batch(k * LM_BATCH, seq, cfg.vocab_size, seed)
            batch = {n: torch.from_numpy(v).cuda().reshape(
                k, LM_BATCH, seq) for n, v in nb.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t1 = time.perf_counter()
            if i == SSM_STEPS - 1:
                with tap:
                    loss, params = step(params, batch)
                tap_host = _host_gb()
            else:
                with sel:
                    loss, params = step(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            counts.append(_launch_counts())
            peaks.append(_peak_gb(torch))
            losses.append(float(loss))
            if seq == LM_SEQ:
                short = batch
    finally:
        dist.client_gradients = real_grads
    flips = tap.flips(LM_RATE)
    launched = [(w["kernel_launches"]["channel_norm"],
                 w["kernel_launches"]["select_mask"]) for w in sel.windows]
    largest = max(math.prod(s[1:-1]) * s[-1] for table in tap.tables
                  for s, _ in table)
    log(f"lm-ssm: {SSM_STEPS} federated steps of {cfg.name}, the first "
        f"of {SSM_LONG_CLIENTS} x {LM_BATCH} x {SSM_LONG_SEQ} tokens "
        f"({SSM_LONG_SEQ // cfg.ssm_chunk} SSD chunks of "
        f"{cfg.ssm_chunk}), the others of {SSM_CLIENTS} clients x "
        f"{LM_BATCH} x {LM_SEQ} (rate {LM_RATE}, lr {LM_LR}): losses "
        f"{losses}, step walls "
        f"{[round(w, 4) for w in walls]} s (long and cold, steady, "
        f"checked),"
        f" peaks {[round(p, 2) for p in peaks]} GB (under "
        f"{SSM_PEAK_GB} GB) from {before_gb:.2f} GB allocated before step "
        f"1, the gradient phase's {[round(p, 2) for p in grad_peaks]} GB; "
        f"non-finite gradient leaves a step {nonfinite}; host memory "
        f"after the checked step {tap_host[0]:.1f} GB resident, "
        f"{tap_host[1]:.1f} GB available; K1 and K2 once a leaf table a "
        f"step "
        f"({SSM_TABLES} each; K1 and K2 in the profiled selections of "
        f"steps 1 and 2: {launched}): tables "
        + json.dumps(tap.tables) + f" (K2 row blocks: "
        f"{'none, ' if largest < sm.MAX_ENTRIES else ''}a client's largest "
        f"matrix {largest:,} entries against {sm.MAX_ENTRIES:,}); kept "
        f"fraction a client {tap.frac}; on step {SSM_STEPS}'s tables K1 "
        f"within rtol {LM_K1_RTOL} and no absolute floor (max rel err "
        f"{tap.k1_rel:.3g}; thresholds {flips['threshold']}, plain "
        f"{flips['plain_threshold']}; {flips['channel_flips']} channels "
        f"flipped, all at the threshold) and K2 in place bitwise its plain "
        f"version (values and counts) ({card})")
    for c in counts:
        if (c["channel_norm"], c["select_mask"]) != (SSM_TABLES,
                                                     SSM_TABLES) or any(
                c[k] for k in c if k not in ("channel_norm", "select_mask")):
            raise AssertionError(f"lm-ssm: a federated step launched {c}; "
                                 f"want K1 and K2 once a leaf table "
                                 f"({SSM_TABLES}) and nothing else")
    if (SSM_TABLES, SSM_TABLES) not in launched or any(
            k1 > SSM_TABLES or k2 > SSM_TABLES for k1, k2 in launched):
        raise AssertionError(f"lm-ssm: the profiled selections launched "
                             f"{launched}")
    if tap.k2_tables != SSM_TABLES or len(tap.tables) != SSM_TABLES:
        raise AssertionError(f"lm-ssm: the tapped step checked "
                             f"{tap.k2_tables} tables")
    if not all(math.isfinite(x) for x in losses) or any(nonfinite):
        raise AssertionError(f"lm-ssm: losses {losses}, non-finite "
                             f"gradient leaves a step {nonfinite}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
        raise AssertionError("lm-ssm: non-finite params after the steps")
    if max(peaks) >= SSM_PEAK_GB:
        raise AssertionError(f"lm-ssm: a step's peak {peaks} GB is not "
                             f"under {SSM_PEAK_GB} GB")
    log("lm-ssm: profile of the selection of step 2: "
        + json.dumps({**sel.windows[1], "card": card}))
    out = {"losses": losses, "step_walls": walls, "peaks_gb": peaks,
           "gradient_phase_peaks_gb": grad_peaks, "kept_fraction": tap.frac,
           "selection_profiles": sel.windows, "k1_max_rel_err": tap.k1_rel,
           "flips": flips, "tables": tap.tables,
           "launches": {k: sum(c[k] for c in counts)
                        for k in ("channel_norm", "select_mask")}}
    out["gradient_profile"] = ssm_gradient_profile(torch, bundle, params,
                                                   short, card)
    host = tap.host
    del tap, params
    torch.cuda.empty_cache()
    out["timing"] = moe_time_tables(torch, host, card, tag="lm-ssm")
    return out


def _hybrid_routing_flips(torch, dec, fwd, batch: int, layers: int,
                          k: int) -> dict:
    """The routing of every MoE layer at every position through the cache
    (``dec``: the prefill's calls, one a layer, then each decode step's)
    against the cache-less forward (``fwd``, one call a layer).  In a
    hybrid a flip (another top-k set) reaches every later layer and
    position of its row (the SSM state, the attention keys), so a row's
    first flip — its earliest position, lowest layer — is the one to
    explain: ``first`` (batch,) is each row's first flipped position (the
    sequence length if none), ``delta`` the largest router log-probability
    difference of the two paths where no flip has reached, and ``gaps``
    each first flip's gap between the k-th and (k+1)-th log-probabilities
    of the forward."""
    E = fwd[0].shape[-1]
    flips, diffs, gaps = [], [], []
    for j in range(layers):
        ref = fwd[j].reshape(batch, -1, E)
        got = torch.cat([dec[j].reshape(batch, -1, E)]
                        + [d.reshape(batch, 1, E)
                           for d in dec[layers + j::layers]], 1)
        lp_ref, lp_got = torch.log(ref), torch.log(got)
        diffs.append((lp_got - lp_ref).abs().amax(-1))       # (batch, T)
        want = torch.sort(torch.topk(ref, k, axis=-1).indices, axis=-1).values
        have = torch.sort(torch.topk(got, k, axis=-1).indices, axis=-1).values
        flips.append((want != have).any(-1))                 # (batch, T)
        top = torch.topk(lp_ref, k + 1, axis=-1).values
        gaps.append(top[..., k - 1] - top[..., k])
    flip, diff, gap = (torch.stack(x) for x in (flips, diffs, gaps))
    T = flip.shape[-1]
    t = torch.arange(T, device=flip.device)
    first = torch.where(flip.any(0), t, T).amin(-1)          # (batch,)
    # where no flip has reached: before a row's first flipped position, and
    # there in the layers below its first flip
    at = (t[None] == first[:, None])                         # (batch, T)
    lowest = torch.where(flip, torch.arange(layers, device=flip.device)
                         [:, None, None], layers).amin(0)    # (batch, T)
    clean = (t[None, None] < first[None, :, None]) | (
        at[None] & (torch.arange(layers, device=flip.device)[:, None, None]
                    < lowest[None]))
    first_gaps = [float(gap[lowest[b, first[b]], b, first[b]])
                  for b in range(batch) if int(first[b]) < T]
    return {"first": first, "flips": int(flip.sum()),
            "delta": float(diff[clean].max()) if clean.any() else 0.0,
            "gaps": first_gaps}


def jamba_consistency(torch, bundle, params, card: str) -> dict:
    """At a drop-free capacity (asserted: nothing dropped), the first decode
    steps of jamba against a cache-less forward over the same tokens.
    Each row's first routing flip (``_hybrid_routing_flips``) must sit at
    a router near-tie (its gap within 2δ); the positions of a row before
    its first flip are compared: within LM_LOGIT_MAX / LM_LOGIT_MEAN, and
    the greedy ids equal but where the forward's top two logits lie within
    twice that position's largest |dlogit| (a near-tie of the argmax).
    In bf16 a row's routing flips within its prompt often enough that few
    positions or none are left to compare, so the same weights are also
    run with every expert routed (top-k = E, capacity = T): the routing
    is then no discrete choice, and the decode is held to the forward at
    every position (SSM_LOGIT_MAX / SSM_LOGIT_MEAN, mamba2's bf16 bounds,
    and the greedy rule above)."""
    import dataclasses

    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo
    from repro_torch.models import transformer as T

    cfg = bundle.cfg
    free = model_zoo.build(_drop_free(cfg), device="cuda")
    sv = JAMBA_SERVE
    n = LM_DECODE_CHECKED + 1
    moe_layers = sum(cfg._is_moe_layer(i) for i in range(cfg.num_layers))
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (sv["batch"], sv["prompt"]),
                            generator=gen, dtype=torch.int32, device="cuda")
    with RouteTap(torch, cfg.num_experts, keep=True) as dec, \
            RouteTap(torch, cfg.num_experts) as tap:
        res = generate(free, params, prompts, n, sv["cache"])
    seq = torch.cat([prompts, res.tokens[:, :n - 1]], axis=1)
    with RouteTap(torch, cfg.num_experts, keep=True) as fwd, tap:
        with torch.no_grad():
            h, _ = T.forward_hidden(params, free.cfg, seq, free.ctx)
            full = T.logits_from_hidden(params, free.cfg, h).float()
    if tap.dropped:
        raise AssertionError(f"lm-ssm: {tap.dropped} assignments dropped "
                             f"at the drop-free factor")
    flips = _hybrid_routing_flips(torch, dec.probs, fwd.probs, sv["batch"],
                                  moe_layers, cfg.experts_per_token)
    pos = torch.arange(n, device="cuda") + sv["prompt"] - 1
    clean = pos[None] < flips["first"][:, None]              # (batch, n)
    ref = full[:, pos]                                       # (batch, n, V)
    diffs = (torch.stack(res.logits[:n], 1).float() - ref).abs()
    top2 = torch.topk(ref, 2, axis=-1).values
    tie = top2[..., 0] - top2[..., 1] <= 2 * diffs.amax(-1)
    greedy = torch.argmax(ref, -1).to(torch.int32) == res.tokens[:, :n]
    out = {"drop_free_factor": free.cfg.moe_capacity_factor,
           "routing": tap.summary(), "flipped": flips["flips"],
           "first_flip_positions": [int(f) for f in flips["first"].cpu()],
           "first_flip_gaps": flips["gaps"],
           "router_logprob_delta": flips["delta"],
           "compared": int(clean.sum()),
           "logit_max_abs": float(diffs.amax(-1)[clean].max())
           if clean.any() else None,
           "logit_mean_abs": max((float(diffs[:, i][clean[:, i]].mean())
                                  for i in range(n) if clean[:, i].any()),
                                 default=None),
           "greedy_agree": int((greedy & clean).sum()),
           "greedy_near_ties": int((~greedy & tie & clean).sum())}
    dense = model_zoo.build(dataclasses.replace(
        cfg, experts_per_token=cfg.num_experts, moe_capacity_factor=1.0),
        device="cuda")
    with RouteTap(torch, cfg.num_experts) as every:
        res = generate(dense, params, prompts, n, sv["cache"])
    out["every_expert"] = {
        **_decode_vs_forward(torch, dense, params, prompts, res, n),
        "dropped": every.dropped}
    ev = out["every_expert"]
    if not (all(g <= 2 * flips["delta"] for g in flips["gaps"])
            and not bool((~greedy & ~tie & clean).any())
            and (not out["compared"]
                 or (out["logit_max_abs"] <= LM_LOGIT_MAX
                     and out["logit_mean_abs"] <= LM_LOGIT_MEAN))
            and ev["dropped"] == 0 and ev["greedy_off_tie"] == 0
            and ev["logit_max_abs"] <= SSM_LOGIT_MAX
            and ev["logit_mean_abs"] <= SSM_LOGIT_MEAN):
        raise AssertionError(f"lm-ssm: jamba's decode against the "
                             f"cache-less forward: {out}")
    log(f"lm-ssm: {cfg.name} at the drop-free capacity factor "
        f"{out['drop_free_factor']} (0 of {out['routing']['routed']} "
        f"assignments dropped): {out['flipped']} (layer, row, position) "
        f"routings over {moe_layers} MoE layers chose another top-"
        f"{cfg.experts_per_token}; each row's first flip at positions "
        f"{out['first_flip_positions']} (of {seq.shape[1]}) with gaps "
        f"{out['first_flip_gaps']}, within 2 x the paths' largest router "
        f"difference before any flip {out['router_logprob_delta']:.3g}; "
        f"decode vs full forward at the {out['compared']} of "
        f"{n * sv['batch']} positions before a flip: max |dlogit| "
        f"{out['logit_max_abs']}, mean {out['logit_mean_abs']}, greedy ids "
        f"equal at {out['greedy_agree']} and at a logit near-tie at "
        f"{out['greedy_near_ties']}; with every expert routed (top-"
        f"{cfg.num_experts}, 0 dropped) at all {n * sv['batch']}: max "
        f"|dlogit| {ev['logit_max_abs']:.4g}, mean {ev['logit_mean_abs']:.3g}"
        f", greedy ids equal at {ev['greedy_agree']} of {n} positions, "
        f"{ev['greedy_off_tie']} (row, position) pairs unequal away from a "
        f"near-tie (gate {SSM_LOGIT_MAX} / {SSM_LOGIT_MEAN}) ({card})")
    return out


def phase_mamba2(torch, card: str) -> dict:
    """mamba2-2.7b uncut: serving, then the federated steps."""
    cfg, bundle, params = _ssm_model(torch, SSM_ARCH, card)
    out = {"serve": ssm_serve(torch, bundle, params, card)}
    torch.cuda.empty_cache()
    held = [params]
    del params
    out.update(ssm_steps(torch, cfg, bundle, held, card))
    return out


def phase_jamba(torch, card: str) -> dict:
    """jamba at one period of its layer pattern with 8 of 16 experts,
    serving only (a client's gradient alone would be 51.6 GB)."""
    cfg, bundle, params = _ssm_model(torch, JAMBA_ARCH, card, **JAMBA_CUT)
    out = {"serve": moe_serve(torch, bundle, params, JAMBA_SERVE, card,
                              tag="lm-ssm"),
           "consistency": jamba_consistency(torch, bundle, params, card)}
    return out


def phase_lm_ssm(torch, card: str) -> dict:
    """mamba2-2.7b, then jamba, each freed before the next."""
    torch.cuda.empty_cache()
    mamba = phase_mamba2(torch, card)
    torch.cuda.empty_cache()
    jamba = phase_jamba(torch, card)
    torch.cuda.empty_cache()
    return {"mamba2": mamba, "jamba": jamba, "launches": mamba["launches"],
            "timing": mamba["timing"]}


# the lm-encdec phase: whisper-medium uncut and llama-3.2-vision-11b at
# every published width, bf16, random weights and context embeddings from
# seeds
ENC_ARCH = "whisper-medium"
VIS_ARCH = "llama-3.2-vision-11b"
# prompts of more than one token: a one-token prompt's prefill leaves the
# cross caches empty, as the reference's (ROADMAP C)
ENCDEC_SERVE = dict(batch=4, prompt=32, gen=16, cache=128)
ENCDEC_STEPS = 3                      # cold, steady, checked
ENCDEC_PEAK_GB = 60.0
# the vision model's federated step at one period of its pattern (4 self
# layers, 1 with cross-attention): 2,183,184,384 params, 4.37 GB, where its
# 40 layers (20.2 GB) would need about 80.8 GB for the step's buffers, one
# client's tree and the update's temporaries, even at 2 clients
VIS_STEP_CUT = dict(num_layers=5)
# a federated step's loss at random init sits near ln V (the logits of a
# layer-normed hidden state through a fan-in-scaled unembedding have unit
# spread, which adds about 0.5): the gate is ln V within 1.0
ENCDEC_LOSS_SPREAD = 1.0


def _encdec_model(torch, arch: str, card: str, **cut):
    """(cfg, bundle, params) of ``arch`` at every published width with the
    ``cut`` fields replaced, drawn on the card from seed 0; the count is
    the meta-device tree's (``param_count()``, the reference's closed
    form, is logged beside: for whisper it counts a gated MLP and no norm
    bias)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model_zoo
    from repro_torch.models import transformer as T
    from repro_torch.params import tree_leaves

    cfg = dataclasses.replace(configs.get(arch), **cut)
    before = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = model_zoo.build(cfg, device="cuda")
    params, _ = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    meta = sum(t.numel() for t in tree_leaves(T.init_model(cfg, None)[0]))
    if n != meta:
        raise AssertionError(f"lm-encdec: {n} params, the meta tree {meta}")
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    key, t_ctx = model_zoo.context_input(cfg)
    log(f"lm-encdec: {cfg.name} ({cfg.num_layers}L decoder"
        + (f" + {cfg.encoder_layers}L encoder" if cfg.encoder_layers
           else "") + f", d={cfg.d_model} {cfg.num_heads}H/"
        f"{cfg.num_kv_heads}KV d_ff={cfg.d_ff} vocab={cfg.vocab_size}, "
        f"cross-attention every {cfg.cross_attn_every} layer(s) to "
        f"{t_ctx} context tokens ({key}), {cfg.dtype}; cut: "
        f"{cut or 'none'}; {n:,} params (param_count() "
        f"{cfg.param_count():,}), {gb:.2f} GB, {len(leaves)} leaves, "
        f"{sum(t.ndim >= 2 for t in leaves)} scored) drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s (peak {_peak_gb(torch):.2f} GB "
        f"from {before:.2f} GB allocated before) ({card})")
    return cfg, bundle, params


def _context_embeds(torch, cfg, lead: tuple, seed: int):
    """Context embeddings ``lead + (t_ctx, d_model)`` from a seeded device
    generator: normal, scale 1/sqrt(d_model), drawn in fp32 (zeros would
    make every cross-attention output constant).  (fp32, model dtype)."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import DTYPES

    _, t_ctx = model_zoo.context_input(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(lead + (t_ctx, cfg.d_model), generator=gen,
                    device="cuda") / math.sqrt(cfg.d_model)
    return x, x.to(DTYPES[cfg.dtype])


class EncodeTimer:
    """CUDA events around each ``transformer.encode`` call that
    ``model_zoo`` makes while installed (whisper's encoder inside
    prefill): the device ms from the call's first kernel to its last."""

    def __init__(self, torch):
        from repro_torch.models import transformer as T
        self.torch, self.T = torch, T
        self.events = []

    def __enter__(self):
        self.real = self.T.encode
        self.T.encode = self.call
        return self

    def __exit__(self, *exc):
        self.T.encode = self.real

    def call(self, *args, **kw):
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.real(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> list:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _context_tokens(torch, bundle, params, embeds):
    """What the decoder's cross-attention reads: the encoder's output over
    ``embeds``, or the patch embeddings as given."""
    from repro_torch.models import model_zoo

    key, _ = model_zoo.context_input(bundle.cfg)
    with torch.no_grad():
        return model_zoo._aux_from_batch(params, bundle.cfg, {key: embeds},
                                         bundle.ctx)


def encdec_decode_profile(torch, bundle, params, aux, card: str) -> dict:
    """torch.profiler (device activity only) over 3 steady decode steps at
    batch 4 from a 32-token prompt: wall, device busy share, top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model_zoo

    sv = ENCDEC_SERVE
    key, _ = model_zoo.context_input(bundle.cfg)
    prompts = torch.randint(0, bundle.cfg.vocab_size,
                            (sv["batch"], sv["prompt"]), dtype=torch.int32,
                            device="cuda")
    logits, caches = bundle.prefill_step(params, {
        "tokens": prompts, key: aux,
        "caches": bundle.make_cache(sv["batch"], sv["cache"])})
    token = torch.argmax(logits, -1)[:, None].to(torch.int32)

    def decode(t):
        nonlocal caches, token
        pos = torch.full((sv["batch"], 1), sv["prompt"] + t,
                         dtype=torch.int32, device="cuda")
        lg, caches = bundle.decode_step(params, {
            "token": token, "pos": pos, "caches": caches})
        token = torch.argmax(lg, -1)[:, None].to(torch.int32)

    decode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, 4):
            decode(t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    window = _window(_device_events(prof), wall)
    if not window["events"]:
        raise AssertionError("lm-encdec: the profile of 3 decode steps "
                             "holds no CUDA event")
    log(f"lm-encdec: profile of 3 decode steps of {bundle.cfg.name}: "
        + json.dumps({**window, "card": card}))
    return window


def encdec_serve(torch, bundle, params, card: str, fp32_check: bool
                 ) -> dict:
    """Serving through ``launch.serve.generate`` with context embeddings
    (a warm-up call, the timed batch; whisper's encoder timed inside the
    prefill by CUDA events), the first decode steps (the cross caches
    written at prefill, read a step) held against a cache-less forward
    over the same tokens and context within LM_LOGIT_MAX / LM_LOGIT_MEAN
    and greedy ids equal but at a near-tie; with ``fp32_check`` the same
    in fp32 at full width (the same draws before their rounding) within
    SSM_FP32_LOGIT_MAX / SSM_FP32_LOGIT_MEAN and greedy ids equal; a
    profile of 3 decode steps."""
    from repro_torch.launch.serve import generate

    cfg = bundle.cfg
    sv = ENCDEC_SERVE
    n = LM_DECODE_CHECKED + 1
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (sv["batch"], sv["prompt"]),
                            generator=gen, dtype=torch.int32, device="cuda")
    a32, aux = _context_embeds(torch, cfg, (sv["batch"],), seed=2)
    generate(bundle, params, prompts, 2, sv["cache"], aux=aux)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    with EncodeTimer(torch) as enc:
        res = generate(bundle, params, prompts, sv["gen"], sv["cache"],
                       aux=aux)
    if not (0 <= int(res.tokens.min())
            and int(res.tokens.max()) < cfg.vocab_size):
        raise AssertionError(f"lm-encdec: token ids outside [0, "
                             f"{cfg.vocab_size})")
    steps = sv["gen"] - 1
    out = {"prefill_ms": res.prefill_s * 1e3,
           "encoder_ms_in_prefill": enc.ms(),
           "decode_ms": res.decode_s * 1e3,
           "decode_ms_a_step": res.decode_s * 1e3 / steps,
           "decode_tok_s": sv["batch"] * steps / res.decode_s,
           "peak_gb": _peak_gb(torch),
           "bf16": _decode_vs_forward(
               torch, bundle, params, prompts, res, n,
               aux=_context_tokens(torch, bundle, params, aux))}
    if cfg.encoder_layers and len(out["encoder_ms_in_prefill"]) != 1:
        raise AssertionError(f"lm-encdec: the prefill encoded "
                             f"{len(out['encoder_ms_in_prefill'])} times")
    b16 = out["bf16"]
    ok = (b16["logit_max_abs"] <= LM_LOGIT_MAX
          and b16["logit_mean_abs"] <= LM_LOGIT_MEAN
          and b16["greedy_off_tie"] == 0)
    if fp32_check:
        import dataclasses

        from repro_torch.models import model_zoo
        f32 = model_zoo.build(dataclasses.replace(cfg, dtype="float32"),
                              device="cuda")
        p32, _ = f32.init(torch.Generator(device="cuda").manual_seed(0))
        r32 = generate(f32, p32, prompts, n, sv["cache"], aux=a32)
        out["fp32"] = f = _decode_vs_forward(
            torch, f32, p32, prompts, r32, n,
            aux=_context_tokens(torch, f32, p32, a32))
        ok = ok and (f["logit_max_abs"] <= SSM_FP32_LOGIT_MAX
                     and f["logit_mean_abs"] <= SSM_FP32_LOGIT_MEAN
                     and f["greedy_agree"] == n)
        del f32, p32, r32
        torch.cuda.empty_cache()
    log(f"lm-encdec: serve {cfg.name} batch {sv['batch']} prompt "
        f"{sv['prompt']} gen {sv['gen']} cache {sv['cache']}, context "
        f"{tuple(aux.shape)} {aux.dtype}: prefill {out['prefill_ms']:.2f} ms"
        + (f" (the encoder {out['encoder_ms_in_prefill'][0]:.2f} ms of it "
           f"by events)" if cfg.encoder_layers else "")
        + f", decode {out['decode_ms']:.1f} ms ({out['decode_ms_a_step']:.2f}"
        f" ms a step, {out['decode_tok_s']:.1f} tok/s), peak "
        f"{out['peak_gb']:.2f} GB; decode vs full forward over {n} "
        f"positions: bf16 max |dlogit| {b16['logit_max_abs']:.4g}, mean "
        f"{b16['logit_mean_abs']:.3g}, greedy ids equal at "
        f"{b16['greedy_agree']} of {n}, {b16['greedy_off_tie']} (row, "
        f"position) pairs unequal away from a near-tie (gate {LM_LOGIT_MAX}"
        f" / {LM_LOGIT_MEAN})"
        + (f"; fp32 at full width max |dlogit| "
           f"{out['fp32']['logit_max_abs']:.4g}, mean "
           f"{out['fp32']['logit_mean_abs']:.3g}, greedy ids equal at "
           f"{out['fp32']['greedy_agree']} of {n} (gate "
           f"{SSM_FP32_LOGIT_MAX} / {SSM_FP32_LOGIT_MEAN})"
           if fp32_check else "") + f" ({card})")
    if not (ok and all(bool(torch.isfinite(lg).all())
                       for lg in res.logits)):
        raise AssertionError(f"lm-encdec: decode against the cache-less "
                             f"forward: {out}")
    out["decode_profile"] = encdec_decode_profile(torch, bundle, params,
                                                  aux, card)
    return out


def encdec_steps(torch, cfg, bundle, held: list, card: str, cut: str
                 ) -> dict:
    """ENCDEC_STEPS federated SCBF steps at the launcher's shape
    (LM_CLIENTS x LM_BATCH x LM_SEQ tokens, each client with its own
    context embeddings (K, B, T, D)): losses finite and within
    ENCDEC_LOSS_SPREAD of ln V, K1 and K2 once a leaf table and nothing
    else from the wrapper counts (the params are of one dtype, so a step's
    tables are its scored leaves, ndim >= 2, in tables of MAX_LEAVES:
    whisper's 32 in 2, the vision period's 52 in 4), each step's peak under
    ENCDEC_PEAK_GB, its gradient phase timed apart, the last step's tables
    against the plain versions (``MoeStepTap``), a client's gradient
    profiled (device activity only), then K1 and K2 timed a table.
    ``held`` hands over the only reference to the params."""
    from repro_torch.config import ScbfConfig
    from repro_torch.core import distributed as dist
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.kernels import select_mask as sm
    from repro_torch.models import model_zoo
    from repro_torch.params import tree_leaves

    params = held.pop()
    leaves = tree_leaves(params)
    if len({t.dtype for t in leaves}) != 1:
        raise AssertionError("lm-encdec: the params hold several dtypes")
    tables = -(-sum(t.ndim >= 2 for t in leaves) // sm.MAX_LEAVES)
    del leaves
    key, _ = model_zoo.context_input(cfg)
    scbf = ScbfConfig(upload_rate=LM_RATE, num_clients=LM_CLIENTS)
    step = dist.make_federated_train_step(bundle.loss_fn, scbf, lr=LM_LR)
    losses, walls, counts, peaks, grad = [], [], [], [], []
    tap = MoeStepTap(torch, LM_CLIENTS, "lm-encdec")
    real_grads = dist.client_gradients

    def client_gradients(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_grads(*args)
        torch.cuda.synchronize()
        grad.append((time.perf_counter() - t0, _peak_gb(torch)))
        return out

    dist.client_gradients = client_gradients
    try:
        for i in range(ENCDEC_STEPS):
            nb = synthetic_lm_batch(LM_CLIENTS * LM_BATCH, LM_SEQ,
                                    cfg.vocab_size, i)
            batch = {k: torch.from_numpy(v).cuda().reshape(
                LM_CLIENTS, LM_BATCH, LM_SEQ) for k, v in nb.items()}
            batch[key] = _context_embeds(torch, cfg, (LM_CLIENTS, LM_BATCH),
                                         seed=10 + i)[1]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t1 = time.perf_counter()
            if i == ENCDEC_STEPS - 1:
                with tap:
                    loss, params = step(params, batch)
            else:
                loss, params = step(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            counts.append(_launch_counts())
            peaks.append(_peak_gb(torch))
            losses.append(float(loss))
    finally:
        dist.client_gradients = real_grads
    flips = tap.flips(LM_RATE)
    ln_v = math.log(cfg.vocab_size)
    log(f"lm-encdec: {ENCDEC_STEPS} federated steps of {cfg.name} (cut: "
        f"{cut}; {LM_CLIENTS} clients x {LM_BATCH} x {LM_SEQ} tokens, each "
        f"client's own {key}, rate {LM_RATE}, lr {LM_LR}): losses {losses} "
        f"(ln V {ln_v:.4f}), step walls {[round(w, 4) for w in walls]} s "
        f"(cold, steady, checked), the gradient phase's "
        f"{[round(g, 4) for g, _ in grad]} s, peaks "
        f"{[round(p, 2) for p in peaks]} GB (under {ENCDEC_PEAK_GB} GB), the "
        f"gradient phase's {[round(p, 2) for _, p in grad]} GB; K1 and K2 "
        f"once a leaf table a step ({tables} each): tables "
        + json.dumps(tap.tables) + f"; kept fraction a client {tap.frac}; "
        f"on step {ENCDEC_STEPS}'s tables K1 within rtol {LM_K1_RTOL} and "
        f"no absolute floor (max rel err {tap.k1_rel:.3g}; thresholds "
        f"{flips['threshold']}, plain {flips['plain_threshold']}; "
        f"{flips['channel_flips']} channels flipped, all at the threshold) "
        f"and K2 in place bitwise its plain version (values and counts) "
        f"({card})")
    for c in counts:
        if (c["channel_norm"], c["select_mask"]) != (tables, tables) or any(
                c[k] for k in c if k not in ("channel_norm", "select_mask")):
            raise AssertionError(f"lm-encdec: a federated step launched "
                                 f"{c}; want K1 and K2 once a leaf table "
                                 f"({tables}) and nothing else")
    if tap.k2_tables != tables or len(tap.tables) != tables:
        raise AssertionError(f"lm-encdec: the tapped step checked "
                             f"{tap.k2_tables} tables")
    if not all(math.isfinite(x) and abs(x - ln_v) <= ENCDEC_LOSS_SPREAD
               for x in losses):
        raise AssertionError(f"lm-encdec: losses {losses}, want finite and "
                             f"within {ENCDEC_LOSS_SPREAD} of ln V = "
                             f"{ln_v:.4f}")
    if max(peaks) >= ENCDEC_PEAK_GB:
        raise AssertionError(f"lm-encdec: a step's peak {peaks} GB is not "
                             f"under {ENCDEC_PEAK_GB} GB")
    out = {"losses": losses, "step_walls": walls,
           "gradient_phase_s": [g for g, _ in grad], "peaks_gb": peaks,
           "gradient_phase_peaks_gb": [p for _, p in grad],
           "kept_fraction": tap.frac, "k1_max_rel_err": tap.k1_rel,
           "flips": flips, "tables": tap.tables,
           "launches": {k: sum(c[k] for c in counts)
                        for k in ("channel_norm", "select_mask")}}
    out["gradient_profile"] = ssm_gradient_profile(
        torch, bundle, params, batch, card, tag="lm-encdec")
    host = tap.host
    del tap, params, batch
    torch.cuda.empty_cache()
    out["timing"] = moe_time_tables(torch, host, card, tag="lm-encdec")
    return out


def phase_whisper(torch, card: str) -> dict:
    """whisper-medium uncut: serving (bf16, and fp32 at full width), then
    the federated steps."""
    cfg, bundle, params = _encdec_model(torch, ENC_ARCH, card)
    out = {"serve": encdec_serve(torch, bundle, params, card,
                                 fp32_check=True)}
    torch.cuda.empty_cache()
    held = [params]
    del params
    out.update(encdec_steps(torch, cfg, bundle, held, card, "none"))
    return out


def phase_vision(torch, card: str) -> dict:
    """llama-3.2-vision-11b at all 40 layers serving, freed, then the
    federated steps at one period of its pattern (VIS_STEP_CUT)."""
    cfg, bundle, params = _encdec_model(torch, VIS_ARCH, card)
    out = {"serve": encdec_serve(torch, bundle, params, card,
                                 fp32_check=False)}
    del bundle, params
    torch.cuda.empty_cache()
    cfg, bundle, params = _encdec_model(torch, VIS_ARCH, card,
                                        **VIS_STEP_CUT)
    held = [params]
    del params
    out.update(encdec_steps(
        torch, cfg, bundle, held, card,
        f"{VIS_STEP_CUT['num_layers']} of 40 layers, one period of the "
        f"pattern: the 40 layers' step would need about 80.8 GB"))
    return out


def phase_lm_encdec(torch, card: str) -> dict:
    """whisper-medium, then llama-3.2-vision, each freed before the
    next."""
    torch.cuda.empty_cache()
    whisper = phase_whisper(torch, card)
    torch.cuda.empty_cache()
    vision = phase_vision(torch, card)
    torch.cuda.empty_cache()
    return {"whisper": whisper, "vision": vision,
            "launches": {k: whisper["launches"][k] + vision["launches"][k]
                         for k in ("channel_norm", "select_mask")},
            "timing": {k: {ENC_ARCH: whisper["timing"][k],
                           VIS_ARCH: vision["timing"][k]}
                       for k in ("channel_norm", "select_mask")}}


# the paper's claimed upload fraction at α = 0.10, and the fraction both
# packages select there at full width from a real local-training delta
# (tests/test_torch_channels.py: the layer-0 rule reveals whole W0 columns)
COMM_PAPER_FRACTION, COMM_TRAINED_FRACTION = 0.45, 0.98


def phase_comm_table(torch, card: str) -> dict:
    """``benchmarks/torch_table_communication.run(quick=False)`` on the card:
    the paper's MLP 2917-256-64-1, one client's upload at each rate (K1
    and K2 in the selection, K3 in the encode: once each a row, K3's
    scatter once a row whose weight leaves ship coo or bitmap), each
    payload's bytes, codecs and values those of the host ``wire.encode``
    of the same masked delta."""
    import numpy as np

    import benchmarks.torch_table_communication as tc
    from repro_torch.comm import wire

    seen = []
    real = wire.encode_selected

    def encode_selected(masked, operands):
        payload = real(masked, operands)
        seen.append((masked, payload))
        return payload

    wire.encode_selected = encode_selected
    _reset_launches()
    try:
        rows = tc.run(quick=False, device="cuda")
    finally:
        wire.encode_selected = real
    counts = _launch_counts()
    scatters = 0
    for masked, payload in seen:
        want = wire.encode(masked)
        if not (want.nbytes == payload.nbytes and all(
                a.codec == b.codec and np.array_equal(a.values, b.values)
                for a, b in zip(want.layers, payload.layers))):
            raise AssertionError("comm-table: the card's encode differs "
                                 "from the host encode")
        scatters += any(lp.codec != "dense" for (_, k), lp in
                        zip(payload.keys, payload.layers) if k == "w")
    want = {"channel_norm": len(rows), "select_mask": len(rows),
            "select_compact_count": len(rows),
            "select_compact_scatter": scatters, "apoz": 0}
    if counts != want:
        raise AssertionError(f"comm-table: launches {counts}, want {want}")
    for line in tc.csv_lines(rows):
        log(f"comm-table: {line}")
    frac = next(r[2] for r in rows if r[:2] == ("positive", 0.10))
    log(f"comm-table: MLP {'-'.join(map(str, tc.FULL))}, positive "
        f"selection at alpha 0.10 uploads {frac:.4f} of the params of a "
        f"random-normal delta (the paper: ~{COMM_PAPER_FRACTION}; a real "
        f"local-training delta: {COMM_TRAINED_FRACTION}); launches "
        f"{counts}; every payload the host encode's ({card})")
    return {"rows": rows, "launches": counts}


# the pods phase: the pod axis (ROADMAP A15) on the card — an NCCL group
# of one in this process, then two ranks sharing cuda:0 over gloo (NCCL
# refuses two ranks on one card); two ranks on one card are no measure of
# pod scaling, so their walls are logged and nothing is claimed from them
POD_RUNS = {    # label: (method, loops, scbf, fed) — as the no-group run
    "scbf": ("scbf", K_LOOPS, {}, {}),
    "scbf_dp": ("scbf", K_LOOPS, DP, {}),
    "scbfwp_mask": ("scbf", WP_LOOPS, dict(
        prune=True, prune_rate=PRUNE_RATE, prune_total=PRUNE_TOTAL,
        prune_impl="mask", prune_compact=True), {}),
    "scbf_fused": ("scbf", FUSE_LOOPS, {}, dict(fuse_rounds=FUSE)),
}
POD_NCCL_RUNS = ("scbf", "scbf_fused")
POD_RANKS = 2
POD_LM_CLIENTS = 4                    # K: 2 clients a rank
POD_LM_DENSE_STEPS = 2                # then one compressed step
POD_TIMEOUT_S = 180.0                 # a rank's collectives (gloo)
POD_JOIN_S = 300.0


def _pod_records(res) -> list:
    return [{k: v for k, v in vars(r).items() if k != "wall_time"}
            for r in res.records]


def _pod_run(torch, cohort, label: str, mesh) -> dict:
    """One ``POD_RUNS`` run over ``mesh``: its records (but the walls),
    final weights on the host, wrapper launches, the bytes this rank put
    into collectives, captures and walls."""
    from repro_torch.config import FedConfig, ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.fed import graphs
    from repro_torch.comm import collectives

    method, loops, scbf, fed = POD_RUNS[label]
    cfg = TrainConfig(learning_rate=0.05 / K_CLIENTS, global_loops=loops,
                      local_epochs=2, local_batch_size=256, seed=0,
                      scbf=ScbfConfig(upload_rate=0.10,
                                      num_clients=K_CLIENTS, **scbf),
                      fed=FedConfig(pods=mesh.size(), **fed))
    graphs.reset_captures()
    collectives.reset_traffic()
    _reset_launches()
    res = run_federated(cohort, cfg, method=method,
                        mlp_features=(cohort.num_features, 256, 64, 1),
                        device="cuda", mesh=mesh)
    return {"records": _pod_records(res), "launches": _launch_counts(),
            "params": [{k: v.cpu().numpy() for k, v in layer.items()}
                       for layer in res.final_params],
            "traffic": [collectives.calls, collectives.bytes_sent],
            "captures": graphs.captures,
            "walls": [r.wall_time for r in res.records],
            "dense_bytes": res.records[0].dense_bytes // K_CLIENTS}


def _pod_same(torch, label: str, got: dict, want_res) -> None:
    """A pod run against the no-group run of the same draws: records
    (bytes, upload fractions, AUC, hidden sizes, ε) and final weights
    bitwise."""
    import numpy as np
    if got["records"] != _pod_records(want_res):
        raise AssertionError(f"pods: {label} records differ from the "
                             "no-group run's")
    for a, b in zip(got["params"], want_res.final_params):
        for k in a:
            if not np.array_equal(a[k], b[k].cpu().numpy()):
                raise AssertionError(f"pods: {label} final {k} differs "
                                     "from the no-group run's")


def _bf16_ulps(torch, a, b):
    """(entries that differ, the largest difference in bf16 ulps) of two
    bf16 tensors (their bits ordered as integers)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i & 0x7FFF))
    d = (ordered(a) - ordered(b)).abs()
    return int(torch.count_nonzero(d)), int(d.max()) if d.numel() else 0


def _pod_lm(torch, mesh, rank: int) -> dict:
    """qwen2-0.5b uncut on this rank: POD_LM_DENSE_STEPS dense steps and
    one compressed step over the pod mesh (K = POD_LM_CLIENTS clients,
    LM_BATCH x LM_SEQ tokens each), with wrapper launches, bytes put into
    collectives, the step wall and the peak; rank 0 also takes the
    one-rank step of the same params and batch and holds the pod step to
    it (the loss, each leaf's entries that differ and by how many bf16
    ulps, fp32 leaves' relative error)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.config import ScbfConfig
    from repro_torch.core.distributed import make_federated_train_step
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.comm import collectives
    from repro_torch.models import model_zoo
    from repro_torch.params import tree_leaves

    cfg = configs.get(LM_ARCH)
    bundle = model_zoo.build(cfg, device="cuda")
    params, _ = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    scbf = ScbfConfig(upload_rate=LM_RATE, num_clients=POD_LM_CLIENTS)
    comp = dataclasses.replace(scbf, compressed_exchange=True)
    steps = {c: (make_federated_train_step(bundle.loss_fn, s, lr=LM_LR,
                                           mesh=mesh),
                 make_federated_train_step(bundle.loss_fn, s, lr=LM_LR))
             for c, s in ((False, scbf), (True, comp))}
    stream = SyntheticTokenStream(POD_LM_CLIENTS * LM_BATCH, LM_SEQ,
                                  cfg.vocab_size, seed=0)
    out = []
    for i, nb in zip(range(POD_LM_DENSE_STEPS + 1), stream):
        compressed = i == POD_LM_DENSE_STEPS
        batch = {k: torch.from_numpy(v).cuda().reshape(
            POD_LM_CLIENTS, LM_BATCH, LM_SEQ) for k, v in nb.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        collectives.reset_traffic()
        t0 = time.perf_counter()
        loss, new = steps[compressed][0](params, batch)
        torch.cuda.synchronize()
        rec = {"compressed": compressed, "loss": float(loss),
               "wall_s": time.perf_counter() - t0,
               "peak_gb": _peak_gb(torch), "launches": _launch_counts(),
               "traffic": [collectives.calls, collectives.bytes_sent]}
        if rank == 0:
            loss1, one = steps[compressed][1](params, batch)
            rec["one_rank_loss"] = float(loss1)
            rec["bf16"], rec["fp32_max_rel"] = [], 0.0
            for a, b in zip(tree_leaves(new), tree_leaves(one)):
                if a.dtype == torch.bfloat16:
                    rec["bf16"].append(_bf16_ulps(torch, a, b))
                else:
                    rel = ((a - b).abs() / b.abs().clamp(min=1e-30)).max()
                    rec["fp32_max_rel"] = max(rec["fp32_max_rel"],
                                              float(rel))
            del one
        params = new
        out.append(rec)
    leaves = tree_leaves(params)
    return {"steps": out, "params": sum(t.numel() for t in leaves),
            "dense_bytes": sum(t.numel() * t.element_size()
                               for t in leaves)}


def pods_rank(rank: int, world: int) -> dict:
    """One of the gloo ranks sharing cuda:0: the MLP runs of ``POD_RUNS``
    at pods = world on the full cohort, then ``_pod_lm``."""
    import torch

    from repro_torch.data.medical import generate_cohort
    from repro_torch.sharding import mesh as meshes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = meshes.make_pod_mesh(world)
    cohort = generate_cohort()
    mlp = {label: _pod_run(torch, cohort, label, mesh) for label in POD_RUNS}
    del cohort
    torch.cuda.empty_cache()
    return {"mlp": mlp, "lm": _pod_lm(torch, mesh, rank),
            "device": torch.cuda.current_device()}


def _pod_replay_profile(torch, cohort, mesh, card: str) -> dict:
    """One fused round of the full-width MLP replayed under the profiler
    on the NCCL pod mesh of one, beside the same round without a group:
    the device events the pod replay adds (the gather the graph captured)
    and no collective called from the host during the replay."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ScbfConfig
    from repro_torch.data.medical import federated_split
    from repro_torch.fed.engine import BatchedEngine
    from repro_torch.comm import collectives
    from repro_torch.models.mlp_net import init_mlp

    shards = federated_split(cohort.x_train, cohort.y_train, K_CLIENTS,
                             seed=0)
    params = init_mlp((cohort.num_features, 256, 64, 1),
                      torch.Generator().manual_seed(0), "cuda")
    cfg = ScbfConfig(upload_rate=0.10, num_clients=K_CLIENTS)
    gen = torch.Generator().manual_seed(1)
    events = {}
    for label, m in (("no_group", None), ("nccl_pod", mesh)):
        eng = BatchedEngine(shards, 256, 2, "cuda", mesh=m)
        perms = [[torch.randperm(eng.perm_length(k), generator=gen)
                  for _ in range(2)] for k in range(K_CLIENTS)]
        plan = eng.prepare_fused_plan([np.arange(K_CLIENTS)], [0.01], [perms],
                                      horizon=1,
                                      num_slots=eng.fused_num_slots(K_CLIENTS))
        eng.fused_scbf_chunk(params, plan, cfg)      # capture, replay
        (prog,) = eng._programs.values()
        torch.cuda.synchronize()
        collectives.reset_traffic()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prog.graph.replay()
            torch.cuda.synchronize()
        events[label] = _device_events(prof)
        if collectives.calls:
            raise AssertionError("pods: the replay called a collective "
                                 "from the host")
    base, got = events["no_group"], events["nccl_pod"]
    extra = {k: n - base.get(k, (0, 0.0))[0] for k, (n, _) in got.items()
             if n > base.get(k, (0, 0.0))[0]}
    gather = {k: n for k, n in extra.items()
              if "nccl" in k.lower() or "memcpy" in k.lower()}
    if not gather:
        raise AssertionError(f"pods: the NCCL replay shows no collective "
                             f"work; it adds {extra}")
    log(f"pods: (a) one fused round replayed under the profiler, NCCL pod "
        f"mesh of one against no group: the graph adds {extra} — the "
        f"gather's device work {gather} (NCCL runs a one-rank gather as a "
        f"copy); K1 and K2 in the replay "
        f"{_kernel_events(got)['channel_norm']} and "
        f"{_kernel_events(got)['select_mask']} ({card})")
    return {"extra_events": extra, "gather_events": gather}


def phase_pods(torch, cohort, card: str, runs: dict) -> dict:
    """The pod axis on the card: (a) an NCCL group of one in this process
    — SCBF 2 loops per round and 4 fused at ``fuse_rounds`` = 2 through
    the pod path, bitwise the no-group runs of the main path and fused
    phases, and one replay profiled; (b) two gloo ranks on cuda:0
    (``launch.mesh.spawn_ranks``; the kernels were built above, so no
    rank compiles) — SCBF 2 loops, 2 with DP, 8 of SCBFwP mask with
    compaction and 4 fused, each bitwise the no-group run of the same
    draws, with each rank's launches asserted and the bytes it gathered
    a round logged against the dense model's; (c) qwen2-0.5b uncut on
    the same ranks — 2 dense steps and a compressed one of
    POD_LM_CLIENTS clients, each held to the one-rank step of the same
    params and batch.  Returns each run's launches for the kernel
    report."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.sharding import mesh as meshes

    launches = {}
    tmp = tempfile.mkdtemp(prefix="pods-nccl-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0),
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = meshes.make_pod_mesh(1)
        for label in POD_NCCL_RUNS:
            got = _pod_run(torch, cohort, label, mesh)
            _pod_same(torch, f"(a) {label}", got, runs[label][0])
            want = runs[label][1]
            if got["launches"] != want:
                raise AssertionError(f"pods: (a) {label} launched "
                                     f"{got['launches']}, the no-group "
                                     f"run {want}")
            if label == "scbf_fused" and got["captures"] != 1:
                raise AssertionError(f"pods: (a) {label}: "
                                     f"{got['captures']} captures, want 1 "
                                     "(the gather inside the round's graph)")
            launches[f"pods_nccl_{label}"] = got["launches"]
            form = "fused rounds one graph each, the gather captured " \
                "inside" if label == "scbf_fused" else "per round"
            log(f"pods: (a) NCCL group of one, {label} ({form}): records and "
                f"final weights bitwise the no-group run; launches "
                f"{got['launches']}; captures {got['captures']}; "
                f"collective calls {got['traffic'][0]} carrying "
                f"{got['traffic'][1]} B eagerly (the replays' gathers are "
                f"in the graph); walls {[round(w, 4) for w in got['walls']]}"
                f" s ({card})")
        profile = _pod_replay_profile(torch, cohort, mesh, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(pods_rank, POD_RANKS, device="cuda",
                        timeout_s=POD_TIMEOUT_S,
                        join_timeout_s=POD_JOIN_S)
    log(f"pods: (b, c) {POD_RANKS} gloo ranks on cuda:"
        f"{[r['device'] for r in ranks]} ran in "
        f"{time.perf_counter() - t0:.1f}s ({card})")
    for label in POD_RUNS:
        # a rank launches K1, K2 and K3's count once a round (its own
        # slots; the encode on all of them) and K4 once a validation batch
        # of a prune step — what the no-group run launched (a fused run:
        # the train graph's warm-up calls and one emission a chunk)
        want = runs[label][1]
        if "fuse_rounds" not in POD_RUNS[label][3] and (
                want["channel_norm"], want["select_mask"],
                want["select_compact_count"]) != (POD_RUNS[label][1],) * 3:
            raise AssertionError(f"pods: {label}'s no-group run launched "
                                 f"{want}")
        for rank, res in enumerate(ranks):
            got = res["mlp"][label]
            _pod_same(torch, f"(b) {label} rank {rank}", got,
                      runs[label][0])
            if got["launches"] != want:
                raise AssertionError(f"pods: (b) {label} rank {rank} "
                                     f"launched {got['launches']}, want "
                                     f"{want}")
            launches[f"pods_gloo_rank{rank}_{label}"] = got["launches"]
        got = ranks[0]["mlp"][label]
        if label == "scbf_fused" and got["captures"] != 2:
            raise AssertionError(f"pods: (b) {label}: {got['captures']} "
                                 "captures, want 2 (the slot pass and the "
                                 "server step)")
        rounds = len(got["records"])
        form = "fused rounds two graphs each, the gloo gather between" \
            if "fuse_rounds" in POD_RUNS[label][3] else "per round"
        log(f"pods: (b) 2 gloo ranks, {label} ({form}): both ranks' records "
            f"and final weights bitwise the no-group run; per rank launches "
            f"{[r['mlp'][label]['launches'] for r in ranks]}, captures "
            f"{got['captures']}; a rank gathered "
            f"{got['traffic'][1] / rounds:.0f} B a round in "
            f"{got['traffic'][0] / rounds:.1f} calls (the dense model: "
            f"{got['dense_bytes']} B); walls rank 0 "
            f"{[round(w, 4) for w in got['walls']]} s, rank 1 "
            f"{[round(w, 4) for w in ranks[1]['mlp'][label]['walls']]} s "
            f"(two ranks sharing one card: no measure of scaling) ({card})")
    lm = [r["lm"] for r in ranks]
    for i, (s0, s1) in enumerate(zip(lm[0]["steps"], lm[1]["steps"])):
        kind = "compressed" if s0["compressed"] else "dense"
        rel = abs(s0["loss"] - s0["one_rank_loss"]) / abs(
            s0["one_rank_loss"])
        ulps = max((u for _, u in s0["bf16"]), default=0)
        differ = sum(n for n, _ in s0["bf16"])
        want = {"channel_norm": 0, "select_mask": 0} if s0["compressed"] \
            else {"channel_norm": 1, "select_mask": 1}
        for rank, s in enumerate((s0, s1)):
            seen = {k: s["launches"][k] for k in want}
            if seen != want or s["loss"] != s0["loss"]:
                raise AssertionError(f"pods: (c) step {i} rank {rank}: "
                                     f"launches {s['launches']}, loss "
                                     f"{s['loss']} (rank 0 {s0['loss']})")
            launches[f"pods_gloo_rank{rank}_lm_step{i}"] = s["launches"]
        if rel > 1e-6 or ulps > 1 or s0["fp32_max_rel"] > 1e-6:
            raise AssertionError(f"pods: (c) {kind} step {i}: loss rel err "
                                 f"{rel}, bf16 ulps {ulps}, fp32 rel "
                                 f"{s0['fp32_max_rel']}")
        log(f"pods: (c) {LM_ARCH} uncut ({lm[0]['params']:,} params), "
            f"{kind} step {i}, K = {POD_LM_CLIENTS} clients x {LM_BATCH} x "
            f"{LM_SEQ} tokens split 2 + 2: loss {s0['loss']:.6f} against "
            f"the one-rank step's {s0['one_rank_loss']:.6f} (rel err "
            f"{rel:.3g} <= 1e-6); bf16 params within {ulps} ulp of the "
            f"one-rank step's, {differ:,} of {lm[0]['params']:,} entries "
            f"differ; fp32 leaves max rel err {s0['fp32_max_rel']:.3g}; "
            f"launches a rank {s0['launches']}; bytes a rank put into "
            f"collectives {s0['traffic'][1]:,} in {s0['traffic'][0]} calls "
            f"(the dense model: {lm[0]['dense_bytes']:,} B); step wall "
            f"rank 0 {s0['wall_s']:.3f} s, rank 1 {s1['wall_s']:.3f} s; "
            f"peak rank 0 {s0['peak_gb']:.2f} GB, rank 1 "
            f"{s1['peak_gb']:.2f} GB ({card})")
    return {"launches": launches, "profile": profile}


MESH_RANKS = 2
MESH_SHAPES = ((1, 2), (2, 1))          # tensor parallel; FSDP
# decode: 4 steps, cut from 8 for the command's time
MESH_SERVE = dict(batch=4, prompt=32, decode=4, cache=128)
MESH_MOE_DECODE = 4                    # deepseek's decode steps
# deepseek's cache: large enough that the latent cache's gather, which the
# sequence-parallel MLA leaves out, outweighs what it sends instead
MESH_MOE_CACHE = 4096
MESH_CLIENTS = 2                       # the step: 2 clients x LM_BATCH x LM_SEQ
# the sharded step against the one-rank step of the same params and batch
# (stated before the first card run, PERF.md section 6): the loss, the
# share of bf16 param entries that differ, and the norm of the two
# steps' difference over the norm of the one-rank step's update (a
# channel that the threshold keeps in one run and drops in the other
# differs by its whole update)
MESH_LOSS_REL = 1e-2
MESH_BF16_DIFFER = 2e-2
MESH_UPDATE_REL = 0.25
# the selection itself (PERF.md section 6): each run's select-mask
# launches keep exactly the channels whose own score is >= its own
# threshold, and each leaf's sharded scores, as a vector, and the
# threshold lie within MESH_SCORE_REL of the one-rank run's (a row partial
# left unsummed halves a leaf's scores).  A single channel's score is no
# gate: a bias's channel sums gradients that cancel, and its bf16 rounding
# moved one near the threshold by 0.324 (runs DI, DJ)
MESH_SCORE_REL = 0.2
# a step's peak as ``launch.roofline.StepCounter`` counts it (each new
# storage an op makes, held until freed) over the rise of the allocator's
# max_memory_allocated above its state at the step's start (PERF.md
# section 6)
MESH_MEMORY_RATIO = (0.85, 1.15)
MESH_TIMEOUT_S = 300.0
MESH_JOIN_S = 600.0


def _mesh_serve(torch, bundle, params, prompts, follow=None,
                n: int = MESH_SERVE["decode"],
                cache: int = MESH_SERVE["cache"]):
    """``serve.generate``: prefill ``prompts`` into fresh caches of
    ``cache`` slots, then ``n`` greedy decode steps, fed ``follow``'s ids
    (the one-rank run's) where given: (ids (B, 1 + n), the logits of each
    step in fp32, whole on every rank, prefill s, decode s)."""
    from repro_torch.launch.serve import generate

    res = generate(bundle, params, prompts, 1 + n, cache, follow=follow)
    return res.tokens, [t.float() for t in res.logits], res.prefill_s, \
        res.decode_s


class SelectionTap:
    """Keeps a federated step's channel scores and threshold, and for
    each scored leaf which of its channels the select-mask launch kept (a
    column of the masked gradient with an entry that is not 0), this
    rank's local (K, N_local) block of them; ``result`` then joins the
    blocks over the mesh (outside the step's counters)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from repro_torch.core import channels
        from repro_torch.sharding.rules import local_shard
        self.real = channels.factored_mask_slots

        def tapped(leaves, scores, thr, in_place=False):
            masked, frac = self.real(leaves, scores, thr, in_place)
            self.scores = [None if x is None else x.float().cpu()
                           for x in scores]
            self.thr = thr.float().cpu()
            self.kept, self.axes = [], []
            for m, x in zip(masked, scores):
                loc = local_shard(m)
                self.kept.append(None if x is None else (loc != 0).reshape(
                    loc.shape[0], -1, loc.shape[-1]).any(1).to(
                        self.torch.float32))
                self.axes.append(None if x is None else
                                 channels.shard_axes(m))
            return masked, frac
        channels.factored_mask_slots = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.core import channels
        channels.factored_mask_slots = self.real

    def result(self) -> tuple:
        """(scores, threshold, kept channels) whole, on the host."""
        from repro_torch.comm import collectives
        kept = []
        for k, ax in zip(self.kept, self.axes):
            if k is not None and ax is not None:
                k = collectives.shard_gather(
                    collectives.shard_sum(k, ax.mesh, ax.rows), ax.mesh,
                    () if ax.cols is None else (ax.cols,))
            kept.append(None if k is None else (k > 0).cpu())
        return self.scores, self.thr, kept


def _selection_check(torch, one: tuple, sharded: tuple, names=None
                     ) -> dict:
    """The two runs' selections (``SelectionTap.result``): each run's kept
    channels against its own scores and threshold (mismatches, exact);
    the largest score difference relative to the larger of the channel's
    score and the one-rank threshold (``score_rel``, at the leaf and
    channel ``worst``), and each leaf's ``|Δscores| / |scores|`` (the
    largest, ``leaf_rel``, and the three largest by leaf name, ``names``
    the leaves' paths); the threshold's difference; and the channels
    whose choice flips, each within δ = max |Δscore| + max |Δthreshold|
    of the one-rank threshold."""
    def mismatch(sel):
        sc, thr, kept = sel
        return sum(int((k != (x >= thr[:, None])).sum())
                   for x, k in zip(sc, kept) if x is not None)
    (s1, t1, _), (s2, t2, _) = one, sharded
    names = names or [str(i) for i in range(len(s1))]
    pairs = [(n, a, b) for n, a, b in zip(names, s1, s2) if a is not None]
    ds = max(float((b - a).abs().max()) for _, a, b in pairs)
    dt = float((t2 - t1).abs().max())
    score_rel, worst = 0.0, None
    leaf_rel = []
    flips, margin = 0, 0.0
    for n, a, b in pairs:
        rel = (b - a).abs() / torch.maximum(a, t1[:, None])
        i = int(rel.argmax())
        if float(rel.reshape(-1)[i]) > score_rel:
            score_rel = float(rel.reshape(-1)[i])
            worst = (n, i, float(a.reshape(-1)[i]), float(b.reshape(-1)[i]))
        leaf_rel.append((float((b - a).norm() / a.norm().clamp_min(1e-30)),
                         n))
        f = (a >= t1[:, None]) != (b >= t2[:, None])
        flips += int(f.sum())
        if f.any():
            margin = max(margin, float((a - t1[:, None]).abs()[f].max()))
    leaf_rel.sort(reverse=True)
    return {"mismatch": (mismatch(one), mismatch(sharded)),
            "score_rel": score_rel, "worst": worst,
            "leaf_rel": leaf_rel[0][0], "leaves": leaf_rel[:3],
            "thr_rel": float(((t2 - t1).abs() / t1).max()),
            "channels": sum(a.numel() for _, a, _ in pairs), "flips": flips,
            "worst_flip_margin": margin, "delta": ds + dt,
            "thr": float(t1.max())}


class TopTap:
    """Keeps a compressed step's channel choices
    (``core.distributed._top_channels``): each scored leaf's scores
    (K, n), whole on every rank, and its chosen channels (K, k), on the
    host."""

    def __enter__(self):
        from repro_torch.core import distributed
        self.real = distributed._top_channels
        self.scores, self.idx = [], []

        def tapped(leaf, rate):
            scores, idx = self.real(leaf, rate)
            self.scores.append(scores.float().cpu())
            self.idx.append(idx.cpu())
            return scores, idx
        distributed._top_channels = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.core import distributed
        distributed._top_channels = self.real


def _topk_check(torch, one: TopTap, sharded: TopTap) -> dict:
    """Two compressed steps' choices: each run's chosen channels against
    the top-k of its own scores (mismatches: a chosen channel below the
    k-th score or one left out above it, exact); each leaf's
    ``|Δscores| / |scores|`` (the largest, ``leaf_rel``); the channels
    whose choice flips, each within δ = max |Δscore| + max |Δk-th score|
    of the one-rank run's k-th score."""
    def chosen(scores, idx):
        return torch.zeros_like(scores, dtype=torch.bool).scatter_(
            1, idx, True)

    def kth(scores, idx):
        return torch.topk(scores, idx.shape[1], axis=-1).values[:, -1:]
    mismatch = [0, 0]
    for r, tap in enumerate((one, sharded)):
        for sc, ix in zip(tap.scores, tap.idx):
            c, t = chosen(sc, ix), kth(sc, ix)
            mismatch[r] += int(((c & (sc < t)) | (~c & (sc > t))).sum())
    pairs = list(zip(one.scores, sharded.scores, one.idx, sharded.idx))
    ds = max(float((b - a).abs().max()) for a, b, _, _ in pairs)
    dk = max(float((kth(b, j) - kth(a, i)).abs().max())
             for a, b, i, j in pairs)
    flips, margin, leaf_rel = 0, 0.0, 0.0
    for a, b, i, j in pairs:
        f = chosen(a, i) != chosen(b, j)
        flips += int(f.sum())
        if f.any():
            margin = max(margin, float((a - kth(a, i)).abs()[f].max()))
        leaf_rel = max(leaf_rel, float((b - a).norm()
                                       / a.norm().clamp_min(1e-30)))
    return {"mismatch": tuple(mismatch), "leaves": len(pairs),
            "channels": sum(a.numel() for a, _, _, _ in pairs),
            "flips": flips, "worst_flip_margin": margin, "delta": ds + dk,
            "leaf_rel": leaf_rel}


def _memory_base(torch) -> int:
    """The allocation a measured step starts from, with the peak reset:
    earlier garbage collected first (a cycle freed during the step would
    lower the allocator's rise and not the count)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _step_memory(torch, counter, base: int) -> dict:
    """The step's peak as ``counter`` counted it, beside the rise of the
    allocator's peak above ``base`` (``_memory_base``); and what each
    holds at the step's end above it."""
    rise = torch.cuda.max_memory_allocated() - base
    counted = counter.peak_bytes.get("cuda", 0)
    return {"counted": counted, "allocator_rise": rise,
            "ratio": counted / rise,
            "live": counter.live_bytes.get("cuda", 0),
            "net": torch.cuda.memory_allocated() - base,
            "meta": counter.peak_bytes.get("meta", 0)}


def _update_gap(torch, new, want, params) -> tuple:
    """(share of bf16 entries of ``new``, a sharded step's params, that
    differ from the one-rank step's ``want``; the difference's norm over
    the one-rank update's)."""
    differ = total = 0
    diff2 = upd2 = 0.0
    for a, b, p0 in zip(new, want, params):
        a = a.full_tensor()
        differ += int(torch.count_nonzero(a != b))
        total += b.numel()
        diff2 += float(((a.float() - b.float()) ** 2).sum())
        upd2 += float(((b.float() - p0.float()) ** 2).sum())
    return differ / total, math.sqrt(diff2 / upd2)


def _logit_gap(torch, got, want) -> tuple:
    """(max, mean) |Δlogit| over every step's logits."""
    d = [(a - b).abs() for a, b in zip(got, want)]
    return max(float(x.max()) for x in d), \
        float(torch.cat([x.reshape(-1) for x in d]).mean())


def _mesh_qwen(torch, rank: int) -> dict:
    """qwen2-0.5b uncut (bf16, weights drawn on the card from seed 0) on
    each mesh of MESH_SHAPES: serving held to the one-rank logits of the
    same ids, and a federated step of MESH_CLIENTS clients held to the
    one-rank step, with its wrapper launches, its collectives counted
    (``launch.roofline.StepCounter``: DTensor's, and SCBF's score
    exchange from ``comm.collectives``) and its wall with the counter
    on; then the compressed step of the same batch held to the one-rank
    compressed step, its channel choices kept (``TopTap``); each step's
    counted peak beside the allocator's rise (``_step_memory``)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.comm import collectives
    from repro_torch.config import ScbfConfig
    from repro_torch.core import channels
    from repro_torch.core.distributed import make_federated_train_step
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.sharding import mesh as meshes
    from repro_torch.launch.roofline import StepCounter
    from repro_torch.models import model_zoo
    from repro_torch.params import tree_leaves, tree_paths
    from repro_torch.sharding import rules

    cfg = configs.get(LM_ARCH)
    one = model_zoo.build(cfg, device="cuda")
    params, axes = one.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (MESH_SERVE["batch"],
                                                MESH_SERVE["prompt"]),
                            generator=gen, dtype=torch.int32, device="cuda")
    ids, want, _, _ = _mesh_serve(torch, one, params, prompts)
    scbf = ScbfConfig(upload_rate=LM_RATE, num_clients=MESH_CLIENTS)
    nb = next(iter(SyntheticTokenStream(MESH_CLIENTS * LM_BATCH, LM_SEQ,
                                        cfg.vocab_size, seed=0)))
    batch = {k: torch.from_numpy(v).cuda().reshape(MESH_CLIENTS, LM_BATCH,
                                                   LM_SEQ)
             for k, v in nb.items()}
    with SelectionTap(torch) as tap:
        loss1, one_params = make_federated_train_step(
            one.loss_fn, scbf, lr=LM_LR)(params, batch)
    sel1 = tap.result()
    packed = ScbfConfig(upload_rate=LM_RATE, num_clients=MESH_CLIENTS,
                        compressed_exchange=True)
    with TopTap() as top1:
        loss1c, one_packed = make_federated_train_step(
            one.loss_fn, packed, lr=LM_LR)(params, batch)
    names = ["/".join(p) for p, _ in tree_paths(params)]
    # the step's leaf tables, from the gradients' shapes and dtypes
    leaves = [torch.empty((MESH_CLIENTS,) + tuple(p.shape), dtype=p.dtype,
                          device="meta") for p in tree_leaves(params)]
    tables = len(channels._score_tables(
        leaves, [i for i, t in enumerate(leaves) if t.ndim >= 3]))
    out = {"params": sum(t.numel() for t in tree_leaves(params)),
           "tables": tables, "meshes": {}}
    for shape in MESH_SHAPES:
        mesh = meshes.make_host_mesh(shape, device="cuda")
        sh = model_zoo.build(cfg, shard=rules.make_shard_fn(mesh),
                             device="cuda")
        placed = rules.distribute_params(params, axes, mesh)
        local = sum(t.to_local().numel() * t.element_size()
                    for t in tree_leaves(placed))
        _, got, t_prefill, t_decode = _mesh_serve(torch, sh, placed, prompts,
                                                  follow=ids)
        logit_max, logit_mean = _logit_gap(torch, got, want)
        step = make_federated_train_step(sh.loss_fn, scbf, lr=LM_LR,
                                         mesh=mesh)
        base = _memory_base(torch)
        collectives.reset_traffic()
        _reset_launches()
        t0 = time.perf_counter()
        with StepCounter(mesh) as counter, SelectionTap(torch) as tap:
            loss2, new = step(placed, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        memory = _step_memory(torch, counter, base)
        launches = _launch_counts()
        score_exchange = collectives.traffic("mesh")
        selection = _selection_check(torch, sel1, tap.result(), names)
        differ, update_rel = _update_gap(torch, tree_leaves(new),
                                         tree_leaves(one_params),
                                         tree_leaves(params))
        del new
        # the compressed exchange's step of the same batch
        step = make_federated_train_step(sh.loss_fn, packed, lr=LM_LR,
                                         mesh=mesh)
        base = _memory_base(torch)
        collectives.reset_traffic()
        _reset_launches()
        t0 = time.perf_counter()
        with StepCounter(mesh) as packed_counter, TopTap() as top:
            loss2c, new = step(placed, batch)
        torch.cuda.synchronize()
        packed_wall = time.perf_counter() - t0
        packed_memory = _step_memory(torch, packed_counter, base)
        packed_launches = _launch_counts()
        packed_sent = {f"{fam} {kind}": v[2] for (fam, kind), v in
                       collectives.by_kind.items()}
        packed_differ, packed_update_rel = _update_gap(
            torch, tree_leaves(new), tree_leaves(one_packed),
            tree_leaves(params))
        out["meshes"][shape] = {
            "local_param_bytes": local, "logit_max": logit_max,
            "logit_mean": logit_mean, "prefill_s": t_prefill, "decode_s": t_decode,
            "loss": (float(loss2), float(loss1)),
            "bf16_differ": differ, "update_rel": update_rel,
            "launches": launches, "step_wall_s": wall,
            "peak_gb": _peak_gb(torch), "memory": memory,
            "dtensor_collectives": counter.collectives(),
            "score_exchange": score_exchange, "selection": selection,
            "compressed": {
                "loss": (float(loss2c), float(loss1c)),
                "bf16_differ": packed_differ,
                "update_rel": packed_update_rel,
                "launches": packed_launches, "step_wall_s": packed_wall,
                "memory": packed_memory,
                "dtensor_collectives": packed_counter.collectives(),
                "sent": packed_sent,
                "selection": _topk_check(torch, top1, top)}}
        del sh, placed, new
        torch.cuda.empty_cache()
    del params, one_params, one_packed
    torch.cuda.empty_cache()
    return out


def _latents(tree) -> list:
    """The ``ckv`` and ``krope`` leaves of a cache tree."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in ([v] if k in ("ckv", "krope") else _latents(v))]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _latents(v)]
    return []


class MlaDecodeTap:
    """Counts the sequence-parallel MLA's runs
    (``models.layers._mla_attend_seq_shards``) and the query positions of
    each, and runs the ``n``-th decode step of a bundle it wraps under
    ``launch.roofline.StepCounter``: every collective that step issues
    (kind, the local input's shape, the bytes sent over the rank's
    links), and apart the bytes the MLA sends, by kind."""

    def __init__(self, torch, mesh, n: int):
        self.torch, self.mesh, self.n = torch, mesh, n
        self.positions, self.seen, self.mla = [], [], {}
        self.counter = None

    def __enter__(self):
        from repro_torch.models import layers
        self.real = real = layers._mla_attend_seq_shards

        def counted(q_nope, *args, **kw):
            self.positions.append(q_nope.shape[1])
            c = self.counter
            before = dict(c.bytes_by_kind) if c is not None else None
            out = real(q_nope, *args, **kw)
            if c is not None:
                for k, v in c.bytes_by_kind.items():
                    self.mla[k] = self.mla.get(k, 0) + v - before.get(k, 0)
            return out
        layers._mla_attend_seq_shards = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers._mla_attend_seq_shards = self.real

    def wrap(self, bundle):
        """``bundle`` whose ``n``-th decode step runs under the counter."""
        import dataclasses

        from repro_torch.launch.roofline import StepCounter
        seen, torch = self.seen, self.torch
        steps = []

        class Seen(StepCounter):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                self.shape = tuple(args[0].shape) if args and isinstance(
                    args[0], torch.Tensor) else None
                return super().__torch_dispatch__(func, types, args, kwargs)

            def add_collective(self, kind, n, *a, **kw):
                seen.append((kind, self.shape, n))
                super().add_collective(kind, n, *a, **kw)

        def decode_step(params, batch, **kw):
            steps.append(1)
            if len(steps) != self.n:
                return bundle.decode_step(params, batch, **kw)
            self.blocks = sorted({tuple(c.to_local().shape[-3:])
                                  for c in _latents(batch["caches"])})
            with Seen(self.mesh) as self.counter:
                out = bundle.decode_step(params, batch, **kw)
            self.total = self.counter.collectives()
            self.peaks = {k: self.counter.peak_bytes.get(k, 0)
                          for k in ("cuda", "meta")}
            self.counter = None
            return out
        return dataclasses.replace(bundle, decode_step=decode_step)

    def result(self, cfg, batch: int) -> dict:
        """The counts, and the MLA's bytes by hand on (1, 2), a layer: the
        all-gathers of ``q_abs`` (B, 1, H/2, r) fp32 and ``q_rope`` (B,
        1, H/2, rd) in the model's dtype, (P - 1) times their bytes; the
        all-reduces of the rows' max and of the sums of exponentials (B,
        H, 1, 1) fp32, 2(P - 1)/P times theirs; the reduce-scatter of
        ``o_c`` (B, 1, H, r) fp32, (P - 1)/P times its bytes."""
        B, H, r, rd, P = batch, cfg.num_heads, cfg.kv_lora_rank, \
            cfg.qk_rope_dim, 2
        item = self.torch.empty((), dtype=getattr(
            self.torch, cfg.dtype)).element_size()
        L = cfg.num_layers
        hand = {"all-gather": L * (P - 1) * B * (H // P) * (r * 4 + rd * item),
                "all-reduce": L * 2 * (2 * (P - 1) * B * H * 4 // P),
                "reduce-scatter": L * (P - 1) * B * H * r * 4 // P}
        shapes = {shape for _, shape, _ in self.seen}
        return {"positions": self.positions, "mla": self.mla, "hand": hand,
                "cache_blocks": self.blocks,
                "cache_gathers": sorted(shapes & set(self.blocks)),
                "step": self.total, "peaks": self.peaks}


def _mesh_deepseek(torch, rank: int) -> dict:
    """deepseek-v2 at depth MOE_DEPTH, every published width, drop-free,
    served from caches of MESH_MOE_CACHE slots on the (1, 2) mesh (80 of
    its 160 experts a rank) against the one-rank logits of the same ids,
    with the router probabilities of both runs kept (``RouteTap``) and
    the sequence-parallel MLA counted (``MlaDecodeTap``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.sharding import mesh as meshes
    from repro_torch.models import model_zoo
    from repro_torch.params import tree_leaves
    from repro_torch.sharding import rules

    cfg = _drop_free(dataclasses.replace(configs.get(MOE_DEEPSEEK),
                                         num_layers=MOE_DEPTH))
    one = model_zoo.build(cfg, device="cuda")
    params, axes = one.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (MESH_SERVE["batch"],
                                                MESH_SERVE["prompt"]),
                            generator=gen, dtype=torch.int32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with RouteTap(torch, cfg.num_experts, keep=True) as r1:
        ids, want, _, _ = _mesh_serve(torch, one, params, prompts,
                                      n=MESH_MOE_DECODE,
                                      cache=MESH_MOE_CACHE)
    mesh = meshes.make_host_mesh((1, 2), device="cuda")
    sh = model_zoo.build(cfg, shard=rules.make_shard_fn(mesh), device="cuda")
    placed = rules.distribute_params(params, axes, mesh)
    experts = placed["stack"]["l0"]["moe"]["wi"].to_local().shape[1]
    local = sum(t.to_local().numel() * t.element_size()
                for t in tree_leaves(placed))
    del params
    torch.cuda.empty_cache()
    with RouteTap(torch, cfg.num_experts, keep=True) as r2, \
            MlaDecodeTap(torch, mesh, MESH_MOE_DECODE) as tap:
        _, got, t_prefill, t_decode = _mesh_serve(
            torch, tap.wrap(sh), placed, prompts, follow=ids,
            n=MESH_MOE_DECODE, cache=MESH_MOE_CACHE)
    return {"experts_local": experts, "local_param_bytes": local,
            "mla": tap.result(cfg, MESH_SERVE["batch"]),
            "layers": cfg.num_layers,
            "want": [w.cpu() for w in want], "got": [g.cpu() for g in got],
            "probs": ([p.cpu() for p in r1.probs],
                      [p.cpu() for p in r2.probs]),
            "k": cfg.experts_per_token, "num_experts": cfg.num_experts,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "peak_gb": _peak_gb(torch)}


def mesh_rank(rank: int, world: int) -> dict:
    """One of the gloo ranks sharing cuda:0: ``_mesh_qwen``, then
    ``_mesh_deepseek``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    qwen = _mesh_qwen(torch, rank)
    return {"qwen": qwen, "deepseek": _mesh_deepseek(torch, rank),
            "device": torch.cuda.current_device()}


def _mesh_routing_check(torch, ds: dict) -> dict:
    """deepseek's sharded logits against the one-rank ones under the MoE
    tie rule of ROADMAP C: each logged step's rows whose MoE routing (the
    model's last layer: a flip changes only its own position) chose the
    same experts in both runs within LM_LOGIT_MAX / LM_LOGIT_MEAN; a
    flipped row only where the one-rank run's k-th and (k+1)-th router
    log-probabilities lie within 2δ, δ the runs' largest router
    log-probability difference."""
    k, B, P = ds["k"], MESH_SERVE["batch"], MESH_SERVE["prompt"]
    p1, p2 = ds["probs"]
    # the router's rows at each logged step: the prompt's last position,
    # then each decode token
    def at_steps(probs):
        return [probs[0].reshape(B, P, -1)[:, -1]] + \
            [p.reshape(B, -1) for p in probs[1:]]
    r1, r2 = at_steps(p1), at_steps(p2)
    delta = max(float((torch.log(b) - torch.log(a)).abs().max())
                for a, b in zip(r1, r2))
    flips = gaps = 0
    worst_gap = 0.0
    kept = []
    for a, b, w, g in zip(r1, r2, ds["want"], ds["got"]):
        sa = torch.sort(torch.topk(a, k, axis=-1).indices, axis=-1).values
        sb = torch.sort(torch.topk(b, k, axis=-1).indices, axis=-1).values
        flip = (sa != sb).any(-1)
        top = torch.topk(torch.log(a), k + 1, axis=-1).values
        gap = top[:, k - 1] - top[:, k]
        for row in range(B):
            if flip[row]:
                flips += 1
                worst_gap = max(worst_gap, float(gap[row]))
                gaps += float(gap[row]) > 2 * delta
            else:
                kept.append((g[row] - w[row]).abs())
    d = torch.stack(kept)
    return {"flips": flips, "far_flips": gaps, "delta": delta,
            "worst_flip_gap": worst_gap, "logit_max": float(d.max()),
            "logit_mean": float(d.mean()), "rows_compared": len(kept)}


def phase_mesh(torch, card: str) -> dict:
    """The ``(data, model)`` mesh on the card (ROADMAP A15b): two gloo
    ranks sharing cuda:0 (``spawn_ranks``; NCCL refuses two ranks on one
    card; DTensor's all-gathers and all-to-alls go through host buffers,
    ``sharding.mesh.stage_gloo_gathers``).  qwen2-0.5b uncut (bf16) on
    (1, 2) (tensor parallel) and (2, 1) (FSDP): prefill of 4 x 32 and
    MESH_SERVE['decode'] decode steps fed the one-rank run's greedy ids,
    held to the one-rank logits (LM_LOGIT_MAX / LM_LOGIT_MEAN); a
    federated step of MESH_CLIENTS x LM_BATCH x LM_SEQ held to the
    one-rank step (MESH_* gates), each rank's K1 and K2 launches equal to
    the leaf tables; the compressed step of the same batch held to the
    one-rank compressed step under the same gates and ``_topk_check``'s,
    K1 = K2 = 0; each step's counted memory within MESH_MEMORY_RATIO of
    the allocator's rise, 0 B of it on "meta" (also in the counted
    deepseek decode step).  deepseek-v2 at depth 2, every published
    width, on (1, 2): 80 of its 160 experts a rank, prefill and
    MESH_MOE_DECODE decode steps served against the one-rank logits under
    the MoE tie rule.  Logged: launches, bytes into collectives, walls,
    peaks.
    Two ranks on one card claim no speed.  Returns the launches for the
    kernel report."""
    from repro_torch.launch.mesh import spawn_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(mesh_rank, MESH_RANKS, device="cuda",
                        timeout_s=MESH_TIMEOUT_S, join_timeout_s=MESH_JOIN_S)
    log(f"mesh: {MESH_RANKS} gloo ranks on cuda:"
        f"{[r['device'] for r in ranks]} ran in "
        f"{time.perf_counter() - t0:.1f}s ({card})")
    launches = {}
    for rank, res in enumerate(ranks):
        q = res["qwen"]
        for shape, m in q["meshes"].items():
            tag = f"mesh: {LM_ARCH} uncut ({q['params']:,} params) on " \
                f"{shape} rank {rank}"
            want = {"channel_norm": q["tables"], "select_mask": q["tables"]}
            seen = {k: m["launches"][k] for k in want}
            if seen != want:
                raise AssertionError(f"{tag}: launches {m['launches']}, "
                                     f"want K1 = K2 = {q['tables']} (its "
                                     "leaf tables)")
            launches[f"mesh_rank{rank}_{shape[0]}x{shape[1]}_step"] = \
                m["launches"]
            if not (m["logit_max"] <= LM_LOGIT_MAX
                    and m["logit_mean"] <= LM_LOGIT_MEAN):
                raise AssertionError(f"{tag}: serving logits max "
                                     f"{m['logit_max']} mean "
                                     f"{m['logit_mean']} from the one-rank "
                                     "run's")
            l2, l1 = m["loss"]
            rel = abs(l2 - l1) / abs(l1)
            if rel > MESH_LOSS_REL or m["bf16_differ"] > MESH_BF16_DIFFER \
                    or m["update_rel"] > MESH_UPDATE_REL:
                raise AssertionError(f"{tag}: step loss rel err {rel}, "
                                     f"{m['bf16_differ']:.3g} of bf16 "
                                     "entries differ from the one-rank "
                                     "step, the difference "
                                     f"{m['update_rel']:.3g} of its update")
            sel = m["selection"]
            if sel["mismatch"] != (0, 0) or sel["leaf_rel"] > \
                    MESH_SCORE_REL or sel["thr_rel"] > MESH_SCORE_REL or \
                    sel["worst_flip_margin"] > sel["delta"]:
                raise AssertionError(f"{tag}: selection {sel}")
            c = m["compressed"]
            launches[f"mesh_rank{rank}_{shape[0]}x{shape[1]}_compressed"] \
                = c["launches"]
            l2c, l1c = c["loss"]
            relc = abs(l2c - l1c) / abs(l1c)
            top = c["selection"]
            lo, hi = MESH_MEMORY_RATIO
            log(f"{tag}: compressed step of {MESH_CLIENTS} x {LM_BATCH} x "
                f"{LM_SEQ}: loss {l2c:.6f} against the one-rank compressed "
                f"{l1c:.6f} (rel {relc:.3g} <= {MESH_LOSS_REL}), bf16 "
                f"params {c['bf16_differ']:.3g} of entries differ (<= "
                f"{MESH_BF16_DIFFER}), the difference's norm "
                f"{c['update_rel']:.3g} of the one-rank update's (<= "
                f"{MESH_UPDATE_REL}); launches {c['launches']}; each "
                f"rank's chosen channels the top-k of its own scores "
                f"(mismatches {top['mismatch']}) on {top['leaves']} "
                f"leaves; each leaf's scores within {top['leaf_rel']:.3g} "
                f"of the one-rank run's (<= {MESH_SCORE_REL}); "
                f"{top['flips']} of {top['channels']:,} channel choices "
                f"flip, each within {top['worst_flip_margin']:.3g} <= δ = "
                f"{top['delta']:.3g} of the k-th score; sent over a "
                f"rank's links: SCBF {c['sent']} B, DTensor "
                f"{c['dtensor_collectives']['bytes_by_kind']} B; step wall "
                f"{c['step_wall_s']:.3f} s (the counter on) ({card})")
            log(f"{tag}: memory a step (StepCounter's count against the "
                f"allocator's, above the step's start): "
                + "; ".join(
                    f"{kind} peak {mem['counted']:,} / {mem['allocator_rise']:,}"
                    f" B = {mem['ratio']:.4f} (within {lo}-{hi}), held at "
                    f"its end {mem['live']:,} / {mem['net']:,} B, on "
                    f"\"meta\" {mem['meta']:,} B (want 0)"
                    for kind, mem in (("dense", m["memory"]),
                                      ("compressed", c["memory"])))
                + f" ({card})")
            if {k: c["launches"][k] for k in want} != {k: 0 for k in want}:
                raise AssertionError(f"{tag}: the compressed step launched "
                                     f"{c['launches']}, want K1 = K2 = 0")
            if relc > MESH_LOSS_REL or c["bf16_differ"] > MESH_BF16_DIFFER \
                    or c["update_rel"] > MESH_UPDATE_REL:
                raise AssertionError(f"{tag}: compressed step loss rel err "
                                     f"{relc}, {c['bf16_differ']:.3g} of "
                                     "bf16 entries differ from the one-rank "
                                     "compressed step, the difference "
                                     f"{c['update_rel']:.3g} of its update")
            if top["mismatch"] != (0, 0) or top["leaf_rel"] > \
                    MESH_SCORE_REL or top["worst_flip_margin"] > top["delta"]:
                raise AssertionError(f"{tag}: compressed selection {top}")
            for kind, mem in (("dense", m["memory"]),
                              ("compressed", c["memory"])):
                if mem["meta"]:
                    raise AssertionError(
                        f"{tag}: the {kind} step's counter held "
                        f"{mem['meta']:,} B on \"meta\": DTensor's "
                        "sharding propagation was counted as a device's")
                if not lo <= mem["ratio"] <= hi:
                    raise AssertionError(
                        f"{tag}: the {kind} step's counted peak "
                        f"{mem['counted']:,} B is {mem['ratio']:.4f} of the "
                        f"allocator's rise {mem['allocator_rise']:,} B "
                        f"(want {lo}-{hi})")
            coll = m["dtensor_collectives"]
            log(f"{tag}: selection: the select-mask launches kept exactly "
                f"the channels at or above each run's threshold "
                f"(mismatches {sel['mismatch']}); each leaf's scores within "
                f"{sel['leaf_rel']:.3g} ({sel['leaves'][0][1]}) and the "
                f"threshold within {sel['thr_rel']:.3g} of the one-rank "
                f"run's (<= {MESH_SCORE_REL}); a channel's score within "
                f"{sel['score_rel']:.3g} (at {sel['worst']}, relative to it "
                f"or the threshold); {sel['flips']} of {sel['channels']:,} "
                f"channel choices flip, each within "
                f"{sel['worst_flip_margin']:.3g} <= δ = {sel['delta']:.3g} "
                f"of the threshold {sel['thr']:.3g}")
            log(f"{tag}: {m['local_param_bytes']:,} B of params a rank; "
                f"serving 4 x {MESH_SERVE['prompt']} + "
                f"{MESH_SERVE['decode']} decode steps (the one-rank ids): "
                f"logits max |d| {m['logit_max']:.4f} <= {LM_LOGIT_MAX}, "
                f"mean {m['logit_mean']:.5f} <= {LM_LOGIT_MEAN}; prefill "
                f"{m['prefill_s']:.3f} s, decode {m['decode_s']:.3f} s; "
                f"federated step of {MESH_CLIENTS} x {LM_BATCH} x {LM_SEQ}: "
                f"loss {l2:.6f} against the one-rank {l1:.6f} (rel "
                f"{rel:.3g} <= {MESH_LOSS_REL}), bf16 params "
                f"{m['bf16_differ']:.3g} of entries differ (<= "
                f"{MESH_BF16_DIFFER}), the difference's norm "
                f"{m['update_rel']:.3g} of the one-rank update's (<= "
                f"{MESH_UPDATE_REL}); launches {m['launches']} = its "
                f"{q['tables']} leaf table(s); into collectives a rank: "
                f"DTensor {coll['bytes_by_kind']} B in "
                f"{coll['count_by_kind']} calls, SCBF's score exchange "
                f"{m['score_exchange'][1]:,} B in {m['score_exchange'][0]} "
                f"calls; step wall {m['step_wall_s']:.3f} s (the counter "
                f"on); peak "
                f"{m['peak_gb']:.2f} GB ({card})")
        ds = res["deepseek"]
        chk = _mesh_routing_check(torch, ds)
        tag = f"mesh: {MOE_DEEPSEEK} depth {MOE_DEPTH} on (1, 2) rank {rank}"
        if ds["experts_local"] != ds["num_experts"] // 2:
            raise AssertionError(f"{tag}: {ds['experts_local']} experts a "
                                 "rank")
        if chk["far_flips"] or not (chk["logit_max"] <= LM_LOGIT_MAX and
                                    chk["logit_mean"] <= LM_LOGIT_MEAN):
            raise AssertionError(f"{tag}: {chk}")
        mla = ds["mla"]
        runs = MESH_MOE_DECODE * ds["layers"]
        if mla["positions"] != [1] * runs:
            raise AssertionError(f"{tag}: the sequence-parallel MLA ran "
                                 f"on queries of {mla['positions']} "
                                 f"positions, want {runs} decode runs")
        if mla["mla"] != mla["hand"] or mla["cache_gathers"]:
            raise AssertionError(f"{tag}: the MLA sent {mla['mla']} B, by "
                                 f"hand {mla['hand']} B; collectives of "
                                 f"cache blocks {mla['cache_gathers']}")
        if mla["peaks"]["meta"]:
            raise AssertionError(f"{tag}: the counted decode step held "
                                 f"{mla['peaks']['meta']:,} B on \"meta\" "
                                 "(DTensor's sharding propagation of the "
                                 "stacked caches)")
        log(f"{tag}: decode sequence parallel on the latent cache's split "
            f"({MESH_MOE_CACHE} slots, blocks {mla['cache_blocks']} a "
            f"rank): {len(mla['positions'])} MLA runs of one position, "
            f"none at prefill; the last decode step sent over a rank's "
            f"links {mla['step']['bytes_by_kind']} B in "
            f"{mla['step']['count_by_kind']} calls, the MLA's part "
            f"{mla['mla']} B = the hand count {mla['hand']} B; no "
            f"collective took a block of the cache; its counted peak "
            f"{mla['peaks']['cuda']:,} B on \"cuda\", "
            f"{mla['peaks']['meta']:,} B on \"meta\" (want 0) ({card})")
        log(f"{tag}: {ds['experts_local']} of {ds['num_experts']} experts "
            f"and {ds['local_param_bytes']:,} B of params a rank; served 4 "
            f"x {MESH_SERVE['prompt']} + {MESH_MOE_DECODE} decode "
            f"steps on the one-rank ids: {chk['rows_compared']} rows with "
            f"the same routing within logits max {chk['logit_max']:.4f} / "
            f"mean {chk['logit_mean']:.5f}; {chk['flips']} routing flips, "
            f"each at a near-tie (gap <= {chk['worst_flip_gap']:.3g}, "
            f"2δ = {2 * chk['delta']:.3g}); prefill {ds['prefill_s']:.3f} "
            f"s, decode {ds['decode_s']:.3f} s; peak {ds['peak_gb']:.2f} GB "
            f"({card})")
    return {"launches": launches}


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
        f"python {sys.version.split()[0]}; started in "
        f"{time.perf_counter() - T_START:.1f}s")
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
    t0 = time.perf_counter()
    phase_obs(torch, cohort, card, runs, replayed)
    log(f"phase obs: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_cross_device(torch, cohort, card, runs)
    log(f"phase cross-device: {time.perf_counter() - t0:.1f}s")
    for name, phase, args in (
            ("c1 round", phase_big_round, (torch, cohort, card)),
            ("profile", phase_profile, (torch, cohort, card)),
            ("agreement", phase_agreement, (torch,))):
        t0 = time.perf_counter()
        phase(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    lm = phase_lm(torch, card)
    log(f"phase lm: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    moe = phase_lm_moe(torch, card)
    log(f"phase lm-moe: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ssm = phase_lm_ssm(torch, card)
    log(f"phase lm-ssm: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    encdec = phase_lm_encdec(torch, card)
    log(f"phase lm-encdec: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    comm = phase_comm_table(torch, card)
    log(f"phase comm-table: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    pods = phase_pods(torch, cohort, card, runs)
    log(f"phase pods: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mesh = phase_mesh(torch, card)
    log(f"phase mesh: {time.perf_counter() - t0:.1f}s")
    kinds = {"select_compact": ("select_compact_count",
                                "select_compact_scatter")}
    for r in report:
        by_run = {label: {k: counts[k] for k in kinds.get(r["name"],
                                                         (r["name"],))}
                  for label, (_, counts, _) in runs.items()}
        if r["name"] in lm["launches"]:
            by_run["lm_federated_steps"] = {r["name"]:
                                            lm["launches"][r["name"]]}
            r["lm"] = lm["timing"][r["name"]]
            by_run["lm_moe_federated_steps"] = {r["name"]:
                                                moe["launches"][r["name"]]}
            r["lm_moe"] = moe["timing"][r["name"]]
            by_run["lm_ssm_federated_steps"] = {r["name"]:
                                                ssm["launches"][r["name"]]}
            r["lm_ssm"] = ssm["timing"][r["name"]]
            by_run["lm_encdec_federated_steps"] = {
                r["name"]: encdec["launches"][r["name"]]}
            r["lm_encdec"] = encdec["timing"][r["name"]]
        by_run["comm_table"] = {k: comm["launches"][k]
                                for k in kinds.get(r["name"], (r["name"],))}
        for label, counts in list(pods["launches"].items()) + list(
                mesh["launches"].items()):
            by_run[label] = {k: counts[k] for k in kinds.get(r["name"],
                                                             (r["name"],))
                             if k in counts}
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
                 "pass", "lm", "lm_moe", "lm_ssm", "lm_encdec")}}))
    log(f"total: {time.perf_counter() - T_START:.1f}s")
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
