"""Host dispatch of the SSM federated step, counted on the CPU: the aten
calls that one federated SCBF step of mamba2 makes at its published
depth (64 layers) and SSD head count (80 heads, so 10 head blocks a
layer), at small widths (d_model 320, head dim 8, state 16, vocab 512),
5 clients × 4 × 64 tokens, and those of a prefill of 4 × 32 with 4
decode steps.  These are counts, a property of the program; what each
call costs in time is the card's host's, measured by ``chip_smoke.py``.

    PYTHONPATH=src python benchmarks/torch_ssm_dispatch.py
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.config import ScbfConfig  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.data.tokens import synthetic_lm_batch  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402

CLIENTS, BATCH, SEQ = 5, 4, 64


def aten_calls(fn) -> int:
    """The aten calls ``fn`` makes, nested ones included."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name.startswith("aten::") for e in prof.events())


def main() -> dict:
    cfg = dataclasses.replace(configs.get("mamba2-2.7b"), d_model=320,
                              ssm_head_dim=8, ssm_state=16, vocab_size=512)
    bundle = model_zoo.build(cfg, device="cpu")
    params, _ = bundle.init(0)
    step = dist.make_federated_train_step(
        bundle.loss_fn, ScbfConfig(upload_rate=0.1, num_clients=CLIENTS),
        lr=0.05)
    nb = synthetic_lm_batch(CLIENTS * BATCH, SEQ, cfg.vocab_size, 0)
    batch = {k: torch.from_numpy(v).reshape(CLIENTS, BATCH, SEQ)
             for k, v in nb.items()}
    step(params, batch)                                  # warm-up
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    out = {"layers": cfg.num_layers, "ssd_heads": cfg.num_ssm_heads,
           "step_aten_calls": aten_calls(lambda: step(params, batch)),
           "generate_5_aten_calls": aten_calls(
               lambda: generate(bundle, params, prompts, 5, 128))}
    print(out)
    return out


if __name__ == "__main__":
    main()
