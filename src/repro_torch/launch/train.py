"""Training launcher for the port (counterpart of ``repro.launch.train``).

``--mode medical`` runs the paper's experiment — SCBF, FedAvg and their
APoZ-pruned variants SCBFwP and FAwP (``scbfwp``, ``fedavgwp``) on the
synthetic 30,760 × 2,917 medical cohort, 5 clients — on the CUDA device
(``--device cpu`` on request) and writes one CSV history per method,
with the reference's columns.  ``--engine`` picks the cohort engine
(``batched``, the default, or ``sequential``) and ``--dp-noise`` the DP
noise multiplier of the scbf uploads (0 = off), as in the reference.
The chaos flags are the reference's: ``--fault-trace`` (a seeded fault
spec, ``fed.faults.parse_fault_trace``), ``--deadline-quantile`` and
``--deadline-action`` (the simulated clock), ``--min-valid-participants``
(round quorum), ``--max-update-norm`` and ``--norm-action`` (the norm
gate); ``--events`` writes ``<out>/<method>.events.jsonl``, which
``python -m repro_torch.obs.report`` reads.

``--mode lm`` is federated SCBF fine-tuning of a reduced assigned dense
architecture (``configs.smoke_variant``, as the reference) on the
synthetic token stream, through ``core.distributed.
make_federated_train_step``: ``--clients`` clients (5), ``--batch-size``
sequences each (4 when left at 256), ``--seq-len`` tokens (64),
``--upload-rate`` (0.10), ``--lr`` (0.05), ``--steps`` steps.

Pods: started by ``torchrun`` (``WORLD_SIZE`` > 1) the launcher
initialises the process group (``launch.mesh.init_from_env``: NCCL when
every rank has a card of its own, gloo on the CPU or when ranks share
one) and runs with ``FedConfig.pods`` — the LM step with a pod mesh — of
the world size; every rank computes the same records, and only rank 0
prints and writes outputs.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --mode medical \
        --methods scbf,fedavg,scbfwp,fedavgwp --loops 30 \
        --out experiments/medical_torch
    PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
        --arch qwen2-0.5b --steps 200 --clients 4
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --methods scbf --loops 30
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import os
import time

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
    """The federation scenario of the command line: a ``--fault-trace``
    arms fault injection (its seed defaults to ``--seed``), a
    ``--deadline-quantile`` above 0 the simulated clock."""
    from repro_torch.config import ClockConfig, FedConfig
    from repro_torch.fed.faults import parse_fault_trace

    kw = dict(engine=args.engine, pods=args.pods,
              sample_fraction=args.sample_fraction,
              dropout_rate=args.dropout_rate,
              straggler_rate=args.straggler_rate,
              partition=args.partition,
              dirichlet_alpha=args.dirichlet_alpha,
              min_valid_participants=args.min_valid_participants,
              max_update_norm=args.max_update_norm,
              norm_action=args.norm_action)
    if args.fault_trace:
        faults = parse_fault_trace(args.fault_trace)
        if "seed=" not in args.fault_trace:
            faults = dataclasses.replace(faults, seed=args.seed)
        kw["faults"] = faults
    if args.deadline_quantile > 0:
        kw["clock"] = ClockConfig(enabled=True,
                                  deadline_quantile=args.deadline_quantile,
                                  deadline_action=args.deadline_action)
    return FedConfig(**kw)


def run_medical(args):
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import generate_cohort
    from repro_torch.obs import recording

    cohort = generate_cohort(seed=args.seed)
    lead = args.rank == 0
    if lead:
        os.makedirs(args.out, exist_ok=True)
    fed = fed_config(args)
    results = {}
    for method in args.methods.split(","):
        base, cfg = method_config(method, args, fed)
        rec_ctx = recording(os.path.join(args.out,
                                         f"{method}.events.jsonl")) \
            if args.events and lead else contextlib.nullcontext()
        with rec_ctx:
            res = run_federated(cohort, cfg, method=base, verbose=lead,
                                device=args.device)
        results[method] = res
        if not lead:
            continue
        write_csv(os.path.join(args.out, f"{res.method}.csv"), res)
        print(f"[{res.method}] best auc_roc={res.best('auc_roc'):.4f} "
              f"auc_pr={res.best('auc_pr'):.4f} "
              f"time={res.total_time():.1f}s "
              f"upload={res.total_upload_bytes()/1e6:.1f}MB")
    return results


def run_lm(args):
    import torch

    from repro_torch import configs
    from repro_torch.config import ScbfConfig
    from repro_torch.core.distributed import make_federated_train_step
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models import model_zoo
    from repro_torch.sharding.mesh import make_pod_mesh

    cfg = configs.smoke_variant(configs.get(args.arch))
    bundle = model_zoo.build(cfg, device=args.device)
    params, _ = bundle.init(args.seed)
    scbf = ScbfConfig(upload_rate=args.upload_rate, num_clients=args.clients)
    step = make_federated_train_step(
        bundle.loss_fn, scbf, lr=args.lr,
        mesh=make_pod_mesh(args.pods, device=bundle.device)
        if args.pods > 1 else None)

    K, B, S = args.clients, args.batch_size, args.seq_len
    context = model_zoo.context_input(cfg)
    stream = SyntheticTokenStream(K * B, S, cfg.vocab_size, seed=args.seed)
    t0 = time.time()
    for i, nb in zip(range(args.steps), stream):
        batch = {k: torch.from_numpy(v).to(bundle.device).reshape(K, B, S)
                 for k, v in nb.items()}
        if context is not None:       # the reference's zero embeddings
            batch[context[0]] = torch.zeros(
                (K, B, context[1], cfg.d_model), dtype=torch.bfloat16,
                device=bundle.device)
        loss, params = step(params, batch)
        if args.rank == 0 and (i % max(1, args.steps // 20) == 0
                               or i == args.steps - 1):
            print(f"step {i:4d} loss {float(loss):.4f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
    return params


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
    ap.add_argument("--fault-trace", default=None,
                    help="seeded fault-injection spec, comma-separated "
                         "key=value pairs (e.g. 'crash=0.05,net_fail=0.1,"
                         "bitflip=0.02,nan=0.01'); keys: seed, crash, "
                         "net_fail, retries, backoff, duplicate, bitflip, "
                         "nan, poison, poison_scale")
    ap.add_argument("--deadline-quantile", type=float, default=0.0,
                    help="enable the simulated wall clock and cut each "
                         "cohort at this latency quantile (0 = off)")
    ap.add_argument("--deadline-action", default="drop",
                    choices=["drop", "spill"],
                    help="what happens to deadline misses: drop, or spill "
                         "into a staleness-weighted buffer")
    ap.add_argument("--min-valid-participants", type=int, default=0,
                    help="round quorum: retry with backoff when fewer "
                         "valid updates arrive (0 = off)")
    ap.add_argument("--max-update-norm", type=float, default=0.0,
                    help="server-side L2 norm bound on admitted updates "
                         "(0 = off)")
    ap.add_argument("--norm-action", default="reject",
                    choices=["reject", "clip"],
                    help="over-norm updates are rejected or clipped")
    ap.add_argument("--events", action="store_true",
                    help="write <out>/<method>.events.jsonl flight-recorder "
                         "logs (read them with python -m repro_torch.obs.report)")
    # lm mode
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    # set by main() on a torchrun rank
    ap.set_defaults(rank=0, pods=1)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    owned = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # a torchrun rank: its group (unless the caller made it already),
        # and pods of the world size
        import torch.distributed as dist

        from repro_torch.launch import mesh as pod
        owned = not dist.is_initialized()
        if owned:
            pod.init_from_env(args.device or "cuda")
        args.rank, args.pods = dist.get_rank(), dist.get_world_size()
    try:
        if args.mode == "lm":
            if args.batch_size == 256:
                args.batch_size = 4
            return run_lm(args)
        return run_medical(args)
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
