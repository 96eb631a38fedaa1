"""The main path's DP rounds on the card: the per-loop walls of the
federated run that ``chip_smoke.py``'s ``scbf_dp`` run makes (the
paper's MLP 2917-256-64-1 at full width, 5 clients, 2 local epochs of
batch 256, upload rate 0.10, σ = 1, clip 1; the batched engine, 5 slots
a round), and the DP clip's slot norms timed alone on 8 slots of those
widths in two forms: ``core.privacy.clip_tree`` as the imported package
has it, and one ``(S, …)`` reduction a leaf.  ``--src`` picks the
package, so two trees compare in one call to the card (run parent,
change, change, parent):

    python benchmarks/torch_dp_round_wall.py [--src DIR] [--loops N]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLOTS = 8                              # one chunk (repro_torch.slots)
FEATS = (2917, 256, 64, 1)
ITERS = 200


def one_reduction_clip(torch, tree, max_norm: float):
    """The slot norms of a ``(S, …)`` tree as one reduction over each
    leaf's trailing axes, and the tree scaled by them."""
    sq = None
    for layer in tree:
        for x in layer.values():
            part = torch.sum(x * x, dim=tuple(range(1, x.ndim)))
            sq = part if sq is None else sq + part
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [{k: v * scale.reshape((-1,) + (1,) * (v.ndim - 1))
             for k, v in layer.items()} for layer in tree], norm


def event_ms(torch, fn) -> float:
    """The median of ``ITERS`` CUDA-event timings of ``fn`` (after a
    warm-up of 10)."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(ITERS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"),
                    help="the directory repro_torch is imported from")
    ap.add_argument("--loops", type=int, default=6)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.config import ScbfConfig, TrainConfig
    from repro_torch.core import privacy
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import generate_cohort

    if not torch.cuda.is_available():
        raise SystemExit("torch_dp_round_wall: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = [{"w": torch.randn((SLOTS, a, b), generator=gen, device="cuda"),
             "b": torch.randn((SLOTS, b), generator=gen, device="cuda")}
            for a, b in zip(FEATS[:-1], FEATS[1:])]
    clip = {"clip_tree_ms": event_ms(
        torch, lambda: privacy.clip_tree(tree, 1.0, slots=True)),
        "one_reduction_ms": event_ms(
        torch, lambda: one_reduction_clip(torch, tree, 1.0))}
    del tree

    cohort = generate_cohort()
    cfg = TrainConfig(learning_rate=0.05 / 5, global_loops=args.loops,
                      local_epochs=2, local_batch_size=256, seed=0,
                      scbf=ScbfConfig(upload_rate=0.10, num_clients=5,
                                      dp_noise_multiplier=1.0,
                                      dp_clip_norm=1.0))
    t0 = time.perf_counter()
    res = run_federated(cohort, cfg, method="scbf", mlp_features=FEATS,
                        device="cuda")
    torch.cuda.synchronize()
    walls = [r.wall_time for r in res.records]
    out = {"src": args.src, "card": card, "torch": torch.__version__,
           "slots": SLOTS, **clip, "loop_walls_s": walls,
           "steady_mean_s": statistics.mean(walls[1:]) if len(walls) > 1
           else None, "run_s": time.perf_counter() - t0,
           "sparse_bytes": [r.sparse_bytes for r in res.records]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
