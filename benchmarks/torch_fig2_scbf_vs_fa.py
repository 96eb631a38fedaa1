"""Paper Fig. 2 on the PyTorch/CUDA port: SCBF vs Federated Averaging,
with and without pruning (the counterpart of
``benchmarks/fig2_scbf_vs_fa.py``).

Runs the four methods on the synthetic cohort and reports per-loop
AUC-ROC / AUC-PR, wall time and upload bytes.  The default is the
reference's quick setting (6,000 × 400 cohort, MLP 400-64-16-1, 5
loops); ``--full`` is the paper's: ``generate_cohort(seed=seed)``
(30,760 × 2,917), MLP 2917-256-64-1, 30 loops, 5 clients, 2 local
epochs, batch 256, α = 0.10, reshape pruning.  SCBF's lr is divided by
the number of clients (the server sums the K deltas where FedAvg
averages), as in the reference.

    PYTHONPATH=src python benchmarks/torch_fig2_scbf_vs_fa.py --full

It runs on the CUDA device (``--device cpu`` on request) and writes the
reference's summary keys to ``--out``
(``experiments/torch_fig2_summary_h100.json`` by default).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.config import ScbfConfig, TrainConfig  # noqa: E402
from repro_torch.core.scbf import run_federated  # noqa: E402
from repro_torch.data.medical import generate_cohort  # noqa: E402

DEFAULT_OUT = "experiments/torch_fig2_summary_h100.json"


def run(quick: bool = True, loops: int = None, out: str = None,
        methods=("scbf", "fedavg", "scbfwp", "fedavgwp"), seed: int = 0,
        lr: float = 0.05, upload_rate: float = 0.10, num_clients: int = 5,
        engine: str = None, device: str = "cuda"):
    """(results by method, summary by method) of one Fig. 2 run."""
    if quick:
        cohort = generate_cohort(num_admissions=6000, num_medicines=400,
                                 seed=seed)
        feats = (400, 64, 16, 1)
        loops = loops or 5
    else:
        cohort = generate_cohort(seed=seed)
        feats = (2917, 256, 64, 1)
        loops = loops or 30

    results = {}
    for method in methods:
        base = method.replace("wp", "")
        # the server SUMS the K masked deltas (Algorithm 1) where FedAvg
        # averages: SCBF's local lr over K gives both the same step
        m_lr = lr / num_clients if base == "scbf" else lr
        cfg = TrainConfig(
            learning_rate=m_lr, global_loops=loops, local_epochs=2,
            local_batch_size=256, seed=seed,
            scbf=ScbfConfig(upload_rate=upload_rate,
                            num_clients=num_clients,
                            prune=method.endswith("wp")))
        results[method] = run_federated(cohort, cfg, method=base,
                                        mlp_features=feats, verbose=True,
                                        engine=engine, device=device)

    summary = {}
    for m, res in results.items():
        summary[m] = {
            "best_auc_roc": res.best("auc_roc"),
            "best_auc_pr": res.best("auc_pr"),
            "final_auc_roc": res.final.auc_roc,
            "final_auc_pr": res.final.auc_pr,
            "total_time_s": res.total_time(),
            "total_upload_mb": res.total_upload_bytes() / 1e6,
            "curve_auc_roc": [r.auc_roc for r in res.records],
            "curve_auc_pr": [r.auc_pr for r in res.records],
        }
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    return results, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--loops", type=int, default=None)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--engine", default=None,
                    choices=(None, "batched", "sequential"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    _, summary = run(quick=not args.full, loops=args.loops, out=args.out,
                     num_clients=args.clients, engine=args.engine,
                     device=args.device)
    for m, s in summary.items():
        print(f"{m:10s} best ROC {s['best_auc_roc']:.4f} "
              f"PR {s['best_auc_pr']:.4f} time {s['total_time_s']:.1f}s "
              f"upload {s['total_upload_mb']:.1f}MB")


if __name__ == "__main__":
    main()
