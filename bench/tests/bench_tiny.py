"""A throwaway copy of the benchmark with tiny cells, for the CPU tests.

``tiny_bench(tmp)`` copies ``bench/`` and ``BENCHMARK.json`` into ``tmp``,
links the program's sources beside them, and adds three cells by files
and entries alone (as a later change would add one): the paper's loop
(SCBF and FedAvg), with the limits of the real cell it shrinks, and the
LM step at toy widths of DeepSeek-V2's block, with its metrics' entries.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

for _p in (str(BENCH), str(ROOT / "src"), str(BENCH / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = {
    # name: (config, traffic, driver, the real cell whose limits it takes)
    "mlp-tiny-scbf": ("mlp-tiny", "tiny-scbf", "mlp_federated",
                      "mlp-scbf-fused"),
    "mlp-tiny-fedavg": ("mlp-tiny", "tiny-fedavg", "mlp_federated", None),
    "lm-tiny-step": ("lm-tiny", "tiny-tokens", "lm_fedstep", None),
}

# a DeepSeek-V2 block at toy widths: a dense prefix layer, one MoE layer
LM_TINY = {
    "name": "lm-tiny", "source": "a toy size",
    "port": {"name": "lm-tiny", "family": "moe", "source": "arXiv:2405.04434",
             "num_layers": 2, "d_model": 64, "num_heads": 4,
             "num_kv_heads": 4, "head_dim": 16, "d_ff": 32,
             "vocab_size": 128, "use_mla": True, "kv_lora_rank": 16,
             "qk_rope_dim": 8, "num_experts": 8, "num_shared_experts": 2,
             "experts_per_token": 2, "moe_every": 1, "first_dense_layers": 1,
             "rope_theta": 10000.0, "moe_capacity_factor": 1.25,
             "dtype": "float32"},
    "federated": {"clients": 2, "upload_rate": 0.1, "lr": 0.05},
}
LIMITS = {"mlp-tiny-fedavg": {"change_gap": 1e-4},
          "lm-tiny-step": {"loss_gap": 3.3e-4, "grad1_gap": 5e-3,
                           "change3_gap": 3.5e-3}}
# the LM step's metrics, as a change that adds an LM cell adds them
LM_END_TO_END = [
    {"name": "train_tokens_per_s", "unit": "tokens/s", "better": "higher",
     "bound": 0.01, "source": "host_clock"},
    {"name": "step_ms_p90", "unit": "ms", "better": "lower", "bound": 0.01,
     "source": "host_clock"}]
LM_PER_LAYER = [
    ("idle_share.lm", "%", "lower", "device_trace", "device"),
    ("mfu.lm", "%", "higher", "device_trace", "whole step"),
    ("grad_ms.lm", "ms", "lower", "program_span",
     "core/distributed.client_gradients"),
    ("select_ms.lm", "ms", "lower", "program_span",
     "core/channels.apply_factored_mask_slots"),
    ("update_ms.lm", "ms", "lower", "program_span",
     "client sum and SGD update"),
    ("k1_roofline.lm", "%", "higher", "device_trace", "kernels K1 K2 K3"),
    ("k2_roofline.lm", "%", "higher", "device_trace", "kernels K1 K2 K3")]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _dump(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_bench(tmp: Path) -> Path:
    """The copy's ``bench`` directory."""
    bench = tmp / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    os.symlink(ROOT / "src", tmp / "src")
    spec = _load(ROOT / "BENCHMARK.json")
    mlp = _load(BENCH / "configs" / "mlp-medical.json")
    mlp.update(name="mlp-tiny", features=[40, 16, 8, 1], clients=3,
               batch=16, loops=4,
               cohort=dict(mlp["cohort"], num_admissions=600,
                           num_medicines=40, num_risk_medicines=10,
                           num_interactions=3))
    _dump(mlp, bench / "configs" / "mlp-tiny.json")
    _dump(LM_TINY, bench / "configs" / "lm-tiny.json")
    scbf = _load(BENCH / "traffic" / "paper-scbf-fused.json")
    _dump(dict(scbf, pool=2), bench / "traffic" / "tiny-scbf.json")
    _dump(dict(scbf, pool=2, method="fedavg"),
          bench / "traffic" / "tiny-fedavg.json")
    _dump({"generator": "traffic/tokens.py", "clients": 2, "batch": 2,
           "seq": 16, "pool": 4, "traced_steps": 2},
          bench / "traffic" / "tiny-tokens.json")
    for cfg in ("mlp-tiny", "lm-tiny"):
        spec["configs"].append({"name": cfg, "source": "a toy size",
                                "file": f"bench/configs/{cfg}.json",
                                "reduced": [], "why": "CPU tests"})
    spec["end_to_end"] += [dict(m, workloads=[]) for m in LM_END_TO_END]
    spec["per_layer"] += [
        {"name": n, "unit": u, "better": b, "source": src, "layer": layer,
         "moves": "train_tokens_per_s", "workloads": []}
        for n, u, b, src, layer in LM_PER_LAYER]
    for name, (cfg, traffic, driver, real) in TINY.items():
        limits = LIMITS[name] if real is None else \
            _load(BENCH / "cells" / f"{real}.json")["limits"]
        _dump({"config": cfg, "traffic": traffic, "driver": driver,
               "why": "a toy size of the CPU tests", "limits": limits},
              bench / "cells" / f"{name}.json")
        spec["workloads"].append({"name": name, "config": cfg,
                                  "traffic": traffic, "chips": 1,
                                  "why": "CPU tests"})
        lm = driver == "lm_fedstep"
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and lm == (
                    m["name"] in {e["name"] for e in LM_END_TO_END} or
                    m["name"].endswith(".lm")):
                m["workloads"].append(name)
    _dump(spec, tmp / "BENCHMARK.json")
    return bench


def run_cell(bench: Path, cell: str, seed: int = 3000000001,
             seconds: float = 0.5) -> dict:
    """One run of ``cell`` on the CPU, past the look for a card.  A test
    process may hold JAX from the JAX package's own tests: the run is held
    to what it loads itself."""
    import time

    import run
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", "0"])
    return run.run(args, bench=bench, device="cpu",
                   t_start=time.perf_counter(),
                   preloaded=run.forbidden_modules())
