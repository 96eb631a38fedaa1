"""Training launcher for the port (counterpart of ``repro.launch.train``).

``--mode medical`` runs the paper's experiment — SCBF, FedAvg and their
APoZ-pruned variants SCBFwP and FAwP (``scbfwp``, ``fedavgwp``) on the
synthetic 30,760 × 2,917 medical cohort, 5 clients — on the CUDA device
(``--device cpu`` on request) and writes one CSV history per method,
with the reference's columns.  ``--engine`` picks the cohort engine
(``batched``, the default, or ``sequential``) and ``--dp-noise`` the DP
noise multiplier of the scbf uploads (0 = off), as in the reference.
``--mode lm`` (ROADMAP A14) is not ported yet.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --mode medical \
        --methods scbf,fedavg,scbfwp,fedavgwp --loops 30 \
        --out experiments/medical_torch
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


def method_config(method: str, args, fed=None):
    """(base method, TrainConfig) of one ``--methods`` entry: a ``wp``
    suffix turns pruning on (SCBFwP / FAwP) over its base method."""
    from repro_torch.config import FedConfig, ScbfConfig, TrainConfig

    prune = method.endswith("wp")
    base = method[:-2] if prune else method
    # SCBF sums K client deltas (paper Algorithm 1); FA averages.
    # Scale SCBF's local lr by 1/K for an equal effective server step.
    m_lr = args.lr / args.clients if base == "scbf" else args.lr
    return base, TrainConfig(
        learning_rate=m_lr, global_loops=args.loops,
        local_epochs=args.local_epochs,
        local_batch_size=args.batch_size, seed=args.seed,
        scbf=ScbfConfig(upload_rate=args.upload_rate,
                        selection=args.selection,
                        num_clients=args.clients,
                        prune=prune, prune_rate=args.prune_rate,
                        prune_total=args.prune_total,
                        prune_impl=args.prune_impl,
                        dp_noise_multiplier=args.dp_noise),
        fed=fed or FedConfig())


def fed_config(args):
    """The federation scenario of the command line."""
    from repro_torch.config import FedConfig

    return FedConfig(engine=args.engine,
                     sample_fraction=args.sample_fraction,
                     dropout_rate=args.dropout_rate,
                     straggler_rate=args.straggler_rate,
                     partition=args.partition,
                     dirichlet_alpha=args.dirichlet_alpha)


def run_medical(args):
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import generate_cohort

    cohort = generate_cohort(seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    fed = fed_config(args)
    results = {}
    for method in args.methods.split(","):
        base, cfg = method_config(method, args, fed)
        res = run_federated(cohort, cfg, method=base, verbose=True,
                            device=args.device)
        results[method] = res
        write_csv(os.path.join(args.out, f"{res.method}.csv"), res)
        print(f"[{res.method}] best auc_roc={res.best('auc_roc'):.4f} "
              f"auc_pr={res.best('auc_pr'):.4f} "
              f"time={res.total_time():.1f}s "
              f"upload={res.total_upload_bytes()/1e6:.1f}MB")
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["medical", "lm"], default="medical")
    ap.add_argument("--methods", default="scbf,fedavg,scbfwp,fedavgwp")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--loops", type=int, default=30)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--upload-rate", type=float, default=0.10)
    ap.add_argument("--selection", default="positive")
    ap.add_argument("--prune-rate", type=float, default=0.10)
    ap.add_argument("--prune-total", type=float, default=0.47)
    ap.add_argument("--prune-impl", default="reshape",
                    choices=["reshape", "mask"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/medical_torch")
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "sequential"])
    ap.add_argument("--sample-fraction", type=float, default=1.0)
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--straggler-rate", type=float, default=0.0)
    ap.add_argument("--partition", default="iid",
                    choices=["iid", "dirichlet"])
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="DP noise multiplier on scbf uploads (0 = off)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "lm":
        raise NotImplementedError("--mode lm (the LM zoo) is ROADMAP A14; "
                                  "not ported yet")
    return run_medical(args)


if __name__ == "__main__":
    main()
