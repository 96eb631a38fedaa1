"""Drives SCBF's federated step on DeepSeek-V2 at its published widths
(one chip's share of an expert-parallel stage): ``lm_fedstep``'s step,
set-up and comparison, with the window reporting ``loop_ms`` (the window's
wall over the federated steps it completed: both clients' gradients, the
selection, the sum and the update), the traced window reading the
program's spans on the card (``harness/device_spans``), and the plain
reference ``bench/reference/dsv2.py``.

The MoE layers' slot counter (``models/moe.slot_counts``) is on from the
set-up: the routed slots the held experts were given and those dropped
past capacity, read once after a window.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

from drivers import lm_fedstep
from drivers.lm_fedstep import FIRST_STEPS
from harness.device_spans import SpanTracer
from harness.trace import launch_counts, robust_window

# the program's spans a traced window reads on the card
SPANS = ("client_grad", "select", "sum_update", "mla", "moe.route",
         "moe.experts", "mlp")


class Driver(lm_fedstep.Driver):

    def setup(self, t_start: float) -> Dict[str, float]:
        from repro_torch.models import moe
        self.counts = moe.slot_counts
        self.counts.on = True
        split = super().setup(t_start)
        self.counts.reset()
        return split

    def _slots(self, steps: int) -> Dict[str, float]:
        routed, dropped = self.counts.read()
        self.counts.reset()
        return {"routed_slots": routed / steps,
                "dropped_slots": dropped / steps}

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        sync = self.torch.cuda.synchronize if self.device == "cuda" else \
            (lambda: None)
        losses: List = []
        sync()
        t0 = time.perf_counter()
        while True:
            loss, self.params = self._one(self.params)
            losses.append(loss)
            sync()
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        steps = len(losses)
        failed = sum(not math.isfinite(float(x)) for x in losses)
        self.log(f"window: {steps} steps in {wall:.3f} s; held experts' "
                 f"slots a step {self._slots(steps)}")
        return {"metrics": {"loop_ms": 1e3 * wall / steps},
                "attempted": steps, "failed": int(failed), "wall_s": wall}

    def traced(self) -> dict:
        """The traffic's ``traced_steps`` steps in a traced window, opened
        with a burst of K1 on the step's gradients' dtype and checked
        against the K1/K2 launch counts; the spans' device extents kept
        with it."""
        torch = self.torch
        from repro_torch.kernels.channel_norm import channel_norms_leaves
        steps = int(self.cell.traffic.get("traced_steps", 3))
        g = torch.Generator(device=self.device).manual_seed(self.seed % 997)
        mats = [torch.randn(self.clients, 1024, 1024, generator=g,
                            device=self.device, dtype=torch.bfloat16)]

        def burst():
            for _ in range(3):
                channel_norms_leaves(mats)
                torch.matmul(mats[0][0], mats[0][0])

        tracer = SpanTracer(torch, SPANS)
        t0 = time.perf_counter()

        def attempt():
            self.counts.reset()
            tracer.start(burst)
            before = launch_counts()
            for _ in range(steps):
                _, self.params = self._one(self.params)
            w = tracer.stop()
            after = launch_counts()
            return w, {k: after[k] - before[k] for k in
                       ("channel_norm", "select_mask")}

        w = robust_window(attempt, log=self.log)
        slots = self._slots(steps)
        found: Dict[str, int] = {}
        for name, _, _ in w.device_spans:
            found[name] = found.get(name, 0) + 1
        self.log(f"traced: {time.perf_counter() - t0:.1f} s; held experts' "
                 f"slots a step {slots}; the spans' device extents {found}; "
                 f"{len(w.ops)} device and {len(w.host)} host events")
        return {"window": w, "steps": steps, "attempted": steps,
                "tokens_per_step": self.tokens_per_step, "seq": self.seq,
                "arch": self.arch, "leaves": self.leaves,
                "clients": self.clients, **slots}

    # ------------------------------------------------------------ check
    def check(self) -> Dict[str, float]:
        """``grad1_gap`` and ``change3_gap``; ``loss_gap`` is logged, not
        judged: the fp8 control's losses and those of gates renormalised
        instead of scaled sit as close to the reference's as the sound
        program's (``PERF.md`` §4)."""
        got = self.readings({"losses": self.losses, "grad1": self.grad1,
                             "change3": self.change3}, self.reference())
        self.log(f"loss_gap = {got.pop('loss_gap')!r} (not judged)")
        return got

    def reference(self, precision: str = "fp32") -> dict:
        """The reference's three steps from the seed's weights: each
        step's loss and the norms of the change after the first and the
        third, a leaf each."""
        torch = self.torch
        from reference import dsv2 as ref
        dims = ref.Dims.of(self.arch)
        layers = self.layer_prefixes()
        stored = {n: dtype for n, _, dtype in self.leaves}

        def start():
            return self.lm_weights.draw(self.leaves, self.seed, self.device)

        p = {n: t.to(torch.float32) for n, t in start().items()}
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
