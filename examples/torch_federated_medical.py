"""End-to-end driver of the port: the paper's full experiment on the GPU.

    PYTHONPATH=src python examples/torch_federated_medical.py [--loops 30]

The counterpart of ``examples/federated_medical.py``, with the same flags
and ``--device`` (cuda by default; ``--device cpu`` on request): 30,760
admissions × 2,917 medicines, MLP (2917-256-64-1), 5 clients, 30 global
loops, the four methods (SCBF / FA / SCBFwP / FAwP with APoZ pruning
10% a loop up to 47%), through ``repro_torch.launch.train.run_medical``.
Writes a CSV a method under ``--out``.
"""
import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--loops", type=int, default=30)
    ap.add_argument("--methods", default="scbf,fedavg,scbfwp,fedavgwp")
    ap.add_argument("--out", default="experiments/medical_torch")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clients", type=int, default=5)
    # cross-device scenarios, as the reference's example
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "sequential"])
    ap.add_argument("--sample-fraction", type=float, default=1.0)
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--partition", default="iid",
                    choices=["iid", "dirichlet"])
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
    ap.add_argument("--dp-noise", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def launcher_args(args):
    """The launcher's arguments for this example's flags: the launcher's
    defaults, the paper's local training (2 epochs of batch 256, upload
    rate 0.10, pruning 10% a loop up to 47%) and the flags given."""
    from repro_torch.launch import train

    out = train.parse_args([])
    for name, value in dict(
            methods=args.methods, loops=args.loops, clients=args.clients,
            lr=args.lr, local_epochs=2, batch_size=256, upload_rate=0.10,
            selection="positive", prune_rate=0.10, prune_total=0.47,
            seed=args.seed, out=args.out, engine=args.engine,
            sample_fraction=args.sample_fraction,
            dropout_rate=args.dropout_rate, partition=args.partition,
            dirichlet_alpha=args.dirichlet_alpha, dp_noise=args.dp_noise,
            device=args.device).items():
        setattr(out, name, value)
    return out


def main(argv=None):
    from repro_torch.launch import train
    return train.run_medical(launcher_args(parse_args(argv)))


if __name__ == "__main__":
    main()
