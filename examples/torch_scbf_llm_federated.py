"""SCBF as an LLM training feature on the PyTorch/CUDA port: federated
fine-tuning of a dense transformer with channel-masked gradient exchange,
through ``repro_torch.core.distributed.make_federated_train_step``
(counterpart of ``examples/scbf_llm_federated.py``).

    PYTHONPATH=src python examples/torch_scbf_llm_federated.py \
        --steps 300 --d-model 512 --layers 8 [--device cpu]

Four simulated hospitals each hold a private synthetic token stream; per
step every client computes gradients locally, channel-masks them to the
top-α output channels (the channel-norm and select-mask kernels, one
launch each a step on the card), and only the masked sum crosses the
client boundary.  Loss is logged to show learning under the upload rate.
"""
import argparse
import dataclasses
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2, help="per client")
    ap.add_argument("--clients", type=int, default=4)
    # masked updates touch only the top-α channels per step, so the
    # stable-and-moving lr is ~10× a dense run's (the reference's setting)
    ap.add_argument("--upload-rate", type=float, default=0.25)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    import torch

    from repro_torch import configs
    from repro_torch.config import ScbfConfig
    from repro_torch.core.distributed import make_federated_train_step
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models import model_zoo
    from repro_torch.params import tree_leaves

    cfg = dataclasses.replace(
        configs.get("qwen2-0.5b"),
        name="qwen2-100m-fed",
        num_layers=args.layers, d_model=args.d_model,
        num_heads=8, num_kv_heads=4, head_dim=args.d_model // 8,
        d_ff=args.d_model * 4, vocab_size=args.vocab)
    bundle = model_zoo.build(cfg, device=args.device)
    params, _ = bundle.init(0)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.num_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
          f"-> {n_params/1e6:.1f}M params, {args.clients} clients, "
          f"upload rate {args.upload_rate:.0%}, device {bundle.device}")

    scbf = ScbfConfig(upload_rate=args.upload_rate,
                      num_clients=args.clients)
    step = make_federated_train_step(bundle.loss_fn, scbf, lr=args.lr)

    K, B, S = args.clients, args.batch, args.seq
    stream = SyntheticTokenStream(K * B, S, cfg.vocab_size, seed=1)
    t0 = time.time()
    for i, nb in zip(range(args.steps), stream):
        batch = {k: torch.from_numpy(v).to(bundle.device).reshape(K, B, S)
                 for k, v in nb.items()}
        loss, params = step(params, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            toks = K * B * S * (i + 1)
            dt = time.time() - t0
            print(f"step {i:4d} loss {float(loss):.4f} "
                  f"{toks/dt:,.0f} tok/s  ({dt:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
