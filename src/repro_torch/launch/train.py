"""Training launcher for the port (counterpart of ``repro.launch.train``).

``--mode medical`` runs the paper's experiment — SCBF and FedAvg on the
synthetic 30,760 × 2,917 medical cohort, 5 clients — on the CUDA device
(``--device cpu`` on request) and writes one CSV history per method,
with the reference's columns.  SCBFwP/FAwP (ROADMAP A8) and ``--mode lm``
(ROADMAP A14) are not ported yet.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --mode medical \
        --methods scbf,fedavg --loops 30 --out experiments/medical_torch
"""
from __future__ import annotations

import argparse
import csv
import os

CSV_COLUMNS = ["loop", "auc_roc", "auc_pr", "upload_fraction",
               "sparse_bytes", "dense_bytes", "wall_time",
               "wall_is_amortized", "train_loss", "flops_proxy",
               "hidden_sizes", "participants", "epsilon"]


def write_csv(path: str, res) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_COLUMNS)
        for r in res.records:
            w.writerow([r.loop, r.auc_roc, r.auc_pr, r.upload_fraction,
                        r.sparse_bytes, r.dense_bytes, r.wall_time,
                        int(r.wall_is_amortized),
                        "" if r.train_loss is None else r.train_loss,
                        r.flops_proxy,
                        "x".join(map(str, r.hidden_sizes)),
                        r.num_participants,
                        "" if r.epsilon is None else r.epsilon])


def run_medical(args):
    from repro_torch.config import FedConfig, ScbfConfig, TrainConfig
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import generate_cohort

    methods = args.methods.split(",")
    for method in methods:
        if method.endswith("wp"):
            raise NotImplementedError(
                f"{method}: pruning (SCBFwP/FAwP) is ROADMAP A8; not "
                "ported yet")
    cohort = generate_cohort(seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    fed = FedConfig(sample_fraction=args.sample_fraction,
                    dropout_rate=args.dropout_rate,
                    straggler_rate=args.straggler_rate,
                    partition=args.partition,
                    dirichlet_alpha=args.dirichlet_alpha)
    results = {}
    for method in methods:
        # SCBF sums K client deltas (paper Algorithm 1); FA averages.
        # Scale SCBF's local lr by 1/K for an equal effective server step.
        m_lr = args.lr / args.clients if method == "scbf" else args.lr
        cfg = TrainConfig(
            learning_rate=m_lr, global_loops=args.loops,
            local_epochs=args.local_epochs,
            local_batch_size=args.batch_size, seed=args.seed,
            scbf=ScbfConfig(upload_rate=args.upload_rate,
                            selection=args.selection,
                            num_clients=args.clients),
            fed=fed)
        res = run_federated(cohort, cfg, method=method, verbose=True,
                            device=args.device)
        results[method] = res
        write_csv(os.path.join(args.out, f"{res.method}.csv"), res)
        print(f"[{res.method}] best auc_roc={res.best('auc_roc'):.4f} "
              f"auc_pr={res.best('auc_pr'):.4f} "
              f"time={res.total_time():.1f}s "
              f"upload={res.total_upload_bytes()/1e6:.1f}MB")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["medical", "lm"], default="medical")
    ap.add_argument("--methods", default="scbf,fedavg")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--loops", type=int, default=30)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--upload-rate", type=float, default=0.10)
    ap.add_argument("--selection", default="positive")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/medical_torch")
    ap.add_argument("--sample-fraction", type=float, default=1.0)
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--straggler-rate", type=float, default=0.0)
    ap.add_argument("--partition", default="iid",
                    choices=["iid", "dirichlet"])
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
    args = ap.parse_args(argv)
    if args.mode == "lm":
        raise NotImplementedError("--mode lm (the LM zoo) is ROADMAP A14; "
                                  "not ported yet")
    return run_medical(args)


if __name__ == "__main__":
    main()
