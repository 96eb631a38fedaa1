"""Batched serving launcher for the port: prefill a prompt batch, then
decode (counterpart of ``repro.launch.serve``).

Runs a reduced assigned architecture (``configs.smoke_variant``, as the
reference) end to end on the CUDA device (``--device cpu`` on request;
no fallback).  ``generate`` is the prefill/decode loop on any config, so
a full-width model serves through the same code.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 4 --prompt-len 32 --gen 32
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional

import torch


class Generation(NamedTuple):
    tokens: torch.Tensor           # (B, gen) int32: the sampled ids
    logits: List[torch.Tensor]     # gen x (B, V): the logits each id came from
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(bundle, params, prompts: torch.Tensor, gen: int,
             cache_len: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             aux: Optional[torch.Tensor] = None,
             follow: Optional[torch.Tensor] = None) -> Generation:
    """Prefill ``prompts`` (B, P) int32 into fresh ring-buffer caches of
    ``cache_len`` slots, then decode ``gen - 1`` more tokens one at a time
    (``gen`` in all): greedy at temperature 0, else sampled from
    softmax(logits / temperature) with ``generator``.  ``aux`` (B, T, D)
    is the context of a model with cross-attention (whisper's frame
    embeddings, a vision model's patch embeddings), handed to prefill
    under its batch key; decode reads it from the caches.  ``follow``
    (B, gen) int32, where given, is fed in place of the sampled ids (a
    run held to another's logits on the same ids).  The two phases
    are timed apart, each ending in a device synchronise.  On a mesh (a
    bundle built with ``shard=``, DTensor params) the caches and the
    sampled ids stay DTensors through the loop, and the ids and logits
    come back whole on every rank."""
    from repro_torch.models.model_zoo import context_input

    B, P = prompts.shape
    dev = prompts.device

    def sample(logits):
        if temperature == 0.0:
            return torch.argmax(logits, axis=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / temperature,
                              axis=-1)
        return torch.multinomial(probs, 1, generator=generator
                                 ).to(torch.int32)

    batch = {"tokens": prompts, "caches": bundle.make_cache(B, cache_len)}
    context = context_input(bundle.cfg)
    if (context is None) != (aux is None):
        raise ValueError(f"{bundle.cfg.name}: aux must be given exactly when "
                         f"the model cross-attends")
    if context is not None:
        batch[context[0]] = aux
    t0 = time.perf_counter()
    logits, caches = bundle.prefill_step(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    def pick(logits, i):
        return sample(logits) if follow is None else follow[:, i:i + 1]

    out, seen = [pick(logits, 0)], [logits]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        pos = torch.full((B, 1), P + t, dtype=torch.int32, device=dev)
        logits, caches = bundle.decode_step(
            params, {"token": out[-1], "pos": pos, "caches": caches})
        out.append(pick(logits, t + 1))
        seen.append(logits)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return Generation(_full(torch.cat(out, axis=1)),
                      [_full(t) for t in seen], t_prefill, t_decode)


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor as the whole tensor on every rank (a plain one as is)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Generation:
    args = parse_args(argv)
    from repro_torch import configs
    from repro_torch.models import model_zoo

    cfg = configs.smoke_variant(configs.get(args.arch))
    bundle = model_zoo.build(cfg, device=args.device)
    params, _ = bundle.init(args.seed)

    B, P = args.batch, args.prompt_len
    gen = torch.Generator(device=bundle.device).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            dtype=torch.int32, device=bundle.device)
    # the reference's stub context: zero frame or patch embeddings in bf16
    context = model_zoo.context_input(cfg)
    aux = None if context is None else torch.zeros(
        (B, context[1], cfg.d_model), dtype=torch.bfloat16,
        device=bundle.device)
    res = generate(bundle, params, prompts, args.gen, args.cache_len,
                   args.temperature, gen, aux=aux)

    toks = res.tokens.cpu().numpy()
    print(f"arch={cfg.name} batch={B} prompt={P} gen={args.gen}")
    print(f"prefill: {res.prefill_s*1e3:.1f} ms "
          f"({B*P/res.prefill_s:.0f} tok/s, first call)")
    print(f"decode:  {res.decode_s*1e3:.1f} ms "
          f"({B*(args.gen-1)/max(res.decode_s,1e-9):.0f} tok/s)")
    print("sample token ids[0]:", toks[0, :16])
    return res


if __name__ == "__main__":
    main()
