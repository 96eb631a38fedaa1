"""Drives SCBF's federated step on the model zoo: the step of
``repro_torch.core.distributed.make_federated_train_step`` over
``model_zoo.build(cfg).loss_fn``, K clients a step, on a pool of distinct
token batches that the window cycles through.

Set-up builds the one step, draws the weights on the device from the seed
(``bench/traffic/lm_weights.py``) and drives the step through its first
three batches, keeping each step's loss and the norms of the parameters'
change after the first and the third; that same step then runs the
window.  Once the window has closed and the program's state is freed,
the plain reference (``bench/reference/lm.py``) follows the same three
steps from the same weights and batches.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import numpy as np

from harness import compare
from harness.trace import Tracer, launch_counts, robust_window

FIRST_STEPS = 3


def flatten(tree, prefix: str = ""):
    """(name, tensor) of a nested dict's leaves, in its own order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, prefix + k + ".")
        else:
            yield prefix + k, v


def unflatten(skeleton, values: Dict[str, object], prefix: str = ""):
    return {k: (unflatten(v, values, prefix + k + ".") if isinstance(v, dict)
                else values[prefix + k]) for k, v in skeleton.items()}


class Driver:
    def __init__(self, cell, seed: int, device: str, log=print):
        self.cell, self.seed, self.device, self.log = cell, seed, device, log
        t = cell.traffic
        self.clients, self.rows, self.seq = (int(t["clients"]),
                                             int(t["batch"]), int(t["seq"]))
        self.pool_size = int(t["pool"])
        fed = cell.config["federated"]
        self.rate, self.lr = float(fed["upload_rate"]), float(fed["lr"])
        self.split: Dict[str, float] = {}
        self.walls: List[float] = []

    @property
    def tokens_per_step(self) -> int:
        return self.clients * self.rows * self.seq

    # ------------------------------------------------------------ set-up
    def setup(self, t_start: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        import torch

        from repro_torch.config import ArchConfig, ScbfConfig
        from repro_torch.core import channels
        from repro_torch.core import distributed as dist
        from repro_torch.models import model_zoo
        from repro_torch.models import transformer as T
        self.torch, self.dist, self.channels = torch, dist, channels
        t1 = time.perf_counter()
        torch.zeros(1, device=self.device).add_(1)      # the context
        t1b = time.perf_counter()
        if self.device == "cuda":
            from repro_torch.kernels import build
            build.libraries()
        t2 = time.perf_counter()
        from traffic import lm_weights, tokens
        self.lm_weights = lm_weights
        port = dict(self.cell.config["port"])
        self.arch = ArchConfig(**port)
        skeleton, _ = T.init_model(self.arch, None)
        self.skeleton = skeleton
        self.leaves = [(n, tuple(v.shape), v.dtype)
                       for n, v in flatten(skeleton)]
        pool = tokens.batch_pool(self.seed, self.pool_size, self.clients,
                                 self.rows, self.seq, self.arch.vocab_size)
        self.pool = [{k: torch.as_tensor(v).to(self.device)
                      for k, v in b.items()} for b in pool]
        t3 = time.perf_counter()
        p0 = self._weights()
        t4 = time.perf_counter()
        self.bundle = model_zoo.build(self.arch, device=self.device)
        self.step = dist.make_federated_train_step(
            self.bundle.loss_fn,
            ScbfConfig(upload_rate=self.rate, num_clients=self.clients),
            lr=self.lr)
        # the first steps: the warm-up, and what the reference follows
        self.losses, self.next_batch = [], 0
        params = p0
        for i in range(FIRST_STEPS):
            loss, params = self._one(params)
            self.losses.append(float(loss))
            if i == 0:
                self.grad1 = self._change_norms(p0, params)
                del p0
        self.change3 = self._change_norms(self._weights(), params)
        self.params = params
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t5 = time.perf_counter()
        self.split = {"imports": t1 - t_start, "device_init": t1b - t1,
                      "kernel_load": t2 - t1b,
                      "inputs": t3 - t2, "weights": t4 - t3,
                      "warm_up": t5 - t4}
        return self.split

    def _weights(self):
        """The initial weights, drawn from the seed, as the program's
        tree."""
        return unflatten(self.skeleton, self.lm_weights.draw(
            self.leaves, self.seed, self.device))

    def _change_norms(self, start, now) -> List[float]:
        torch = self.torch
        a, b = dict(flatten(start)), dict(flatten(now))
        return [float(torch.linalg.vector_norm(
            b[n].to(torch.float32) - a[n].to(torch.float32)))
            for n, _, _ in self.leaves]

    def _one(self, params):
        batch = self.pool[self.next_batch % len(self.pool)]
        self.next_batch += 1
        return self.step(params, batch)

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        torch = self.torch
        sync = torch.cuda.synchronize if self.device == "cuda" else \
            (lambda: None)
        losses = []
        sync()
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            loss, self.params = self._one(self.params)
            losses.append(loss)
            sync()
            now = time.perf_counter()
            self.walls.append(now - t1)
            if now - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        failed = sum(not math.isfinite(float(x)) for x in losses)
        steps = len(self.walls)
        metrics = {"train_tokens_per_s": steps * self.tokens_per_step / wall,
                   "step_ms_p90": 1e3 * statistics.quantiles(
                       self.walls, n=10)[-1] if steps >= 2 else
                   1e3 * self.walls[0]}
        return {"metrics": metrics, "attempted": steps, "failed": int(failed),
                "wall_s": wall}

    def traced(self) -> dict:
        """A few steps in a traced window, opened with a burst of K1 on the
        step's own gradients' dtype; the gradient and selection phases
        timed by CUDA events around their module attributes."""
        torch, dist, ch = self.torch, self.dist, self.channels
        from repro_torch.kernels.channel_norm import channel_norms_leaves
        steps = int(self.cell.traffic.get("traced_steps", 3))
        g = torch.Generator(device=self.device).manual_seed(self.seed % 997)
        mats = [torch.randn(self.clients, 1024, 1024, generator=g,
                            device=self.device, dtype=torch.bfloat16)]

        def burst():
            for _ in range(3):
                channel_norms_leaves(mats)
                torch.matmul(mats[0][0], mats[0][0])

        phases = {"grad": [], "select": []}

        def timed(fn, key):
            def run(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                phases[key].append((e0, e1))
                return out
            return run

        real_grads, real_mask = dist.client_gradients, \
            ch.apply_factored_mask_slots
        tracer = Tracer(torch)
        walls: List[float] = []

        def attempt():
            for key in phases:
                phases[key].clear()
            walls.clear()
            tracer.start(burst)
            before = launch_counts()
            for _ in range(steps):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _, self.params = self._one(self.params)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
            w = tracer.stop()
            after = launch_counts()
            return w, {k: after[k] - before[k] for k in
                       ("channel_norm", "select_mask")}

        dist.client_gradients = timed(real_grads, "grad")
        ch.apply_factored_mask_slots = timed(real_mask, "select")
        try:
            w = robust_window(attempt, log=self.log)
        finally:
            dist.client_gradients = real_grads
            ch.apply_factored_mask_slots = real_mask
        torch.cuda.synchronize()
        grad = [a.elapsed_time(b) for a, b in phases["grad"]]
        select = [a.elapsed_time(b) for a, b in phases["select"]]
        return {"window": w, "steps": steps, "attempted": steps,
                "tokens_per_step": self.tokens_per_step, "seq": self.seq,
                "arch": self.arch, "leaves": self.leaves,
                "clients": self.clients,
                "grad_ms": float(np.mean(grad)),
                "select_ms": float(np.mean(select)),
                "step_ms": 1e3 * float(np.mean(walls))}

    # ------------------------------------------------------------ check
    def release(self) -> None:
        del self.params, self.step, self.bundle
        if self.device == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32") -> dict:
        """The reference's three steps from the seed's weights: each
        step's loss and the norms of the change after the first and the
        third, a leaf each."""
        torch = self.torch
        from reference import lm as ref
        a = self.arch
        dims = ref.Dims(d_model=a.d_model, heads=a.num_heads,
                        head_dim=a.head_dim, rope_dim=a.qk_rope_dim,
                        kv_lora=a.kv_lora_rank, experts=a.num_experts,
                        top_k=a.experts_per_token,
                        capacity_factor=a.moe_capacity_factor,
                        rope_theta=a.rope_theta)
        layers = self.layer_prefixes()
        stored = {n: dtype for n, _, dtype in self.leaves}

        def start():
            return self.lm_weights.draw(self.leaves, self.seed, self.device)

        p = {}
        for n, t in start().items():
            p[n] = t.to(torch.float32)
        losses, grad1, raw = [], None, None
        for i in range(FIRST_STEPS):
            rec = ref.fed_step(p, self.pool[i], layers, dims, self.rate,
                               self.lr, stored, precision)
            losses.append(rec.loss)
            if i == 0:
                grad1 = self._ref_norms(start(), p)
                raw = [rec.grad_norms[n] for n, _, _ in self.leaves]
        change3 = self._ref_norms(start(), p)
        del p
        if self.device == "cuda":
            torch.cuda.empty_cache()
        return {"losses": losses, "grad1": grad1, "change3": change3,
                "grad": raw}

    def _ref_norms(self, start, now) -> List[float]:
        torch = self.torch
        out = []
        for n, _, _ in self.leaves:
            out.append(float(torch.linalg.vector_norm(
                now[n] - start.pop(n).to(torch.float32))))
        return out

    def layer_prefixes(self):
        """The blocks in order: (leaf-name prefix, index in its stack)."""
        out = [(f"prefix.p{i}.", None) for i in range(
            self.arch.first_dense_layers)]
        repeats = self.arch.num_layers - self.arch.first_dense_layers
        out += [("stack.l0.", r) for r in range(repeats)]
        return out

    @staticmethod
    def readings(got: dict, ref: dict, detail: bool = False) -> dict:
        out = {"loss_gap": max(compare.rel_gap(a, b) for a, b in
                               zip(got["losses"], ref["losses"])),
               "grad1_gap": compare.worst_norm_gap(
                   got["grad1"], ref["grad1"], ref["grad"]),
               "change3_gap": compare.worst_norm_gap(
                   got["change3"], ref["change3"], ref["grad"])}
        if detail:
            out.update(
                losses=[got["losses"], ref["losses"]],
                grad1_leaves=compare.norm_gaps(
                    got["grad1"], ref["grad1"], ref["grad"]).tolist(),
                change3_leaves=compare.norm_gaps(
                    got["change3"], ref["change3"], ref["grad"]).tolist(),
                ref_grad1=list(ref["grad1"]), ref_grad=list(ref["grad"]),
                got_grad1=list(got["grad1"]))
        return out

    def check(self) -> Dict[str, float]:
        got = {"losses": self.losses, "grad1": self.grad1,
               "change3": self.change3}
        return self.readings(got, self.reference())
