"""Drives the paper's federated loop: whole experiments of
``repro_torch.core.scbf.run_federated`` back to back, each ``loops``
federated loops of SCBF or FedAvg over the cohort, on the batched engine
with fused replays.  Every call builds its own engine, captures its round
and evaluates, as a hospital running the experiment pays for.

Inputs (``bench/traffic/cohort.py``): the cohort from the seed, and a
pool of experiments, each its own initial weights and permutations, that
the window cycles through.  A tap on the engine's emission keeps each
experiment's first uploads (the first loop's payloads, as they crossed
the wire); the reference (``bench/reference/mlp.py``) recomputes one
experiment drawn from the seed once the window has closed.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np

from harness import compare
from harness.trace import Tracer, launch_counts, robust_window


class Driver:
    def __init__(self, cell, seed: int, device: str, log=print):
        self.cell, self.seed, self.device, self.log = cell, seed, device, log
        c, t = cell.config, cell.traffic
        self.features = tuple(c["features"])
        self.method = t["method"]
        self.loops = int(c["loops"])
        self.clients = int(c["clients"])
        self.epochs = int(c["local_epochs"])
        self.batch = int(c["batch"])
        self.rate = float(c["upload_rate"])
        self.lr = float(c["lr"]) / (self.clients if self.method == "scbf"
                                    else 1)
        self.pool_size = int(t["pool"])
        self.fuse = int(c["fuse_rounds"])
        self.done: List[dict] = []
        self.split: Dict[str, float] = {}
        self._first = None
        self._emitted: Optional[list] = None
        self._trace = None
        self._chunks = 0
        self.next_index = 0

    # ------------------------------------------------------------ set-up
    def setup(self, t_start: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        import torch

        from repro_torch.config import FedConfig, ScbfConfig, TrainConfig
        from repro_torch.core import scbf
        from repro_torch.fed import engine, graphs
        self.torch, self.scbf, self.graphs = torch, scbf, graphs
        self.engine = engine
        t1 = time.perf_counter()
        torch.zeros(1, device=self.device).add_(1)      # the context
        t1b = time.perf_counter()
        if self.device == "cuda":
            from repro_torch.kernels import build
            build.libraries()
        t2 = time.perf_counter()
        from traffic.cohort import (experiment_inputs, federated_split,
                                    generate_cohort)
        c = self.cell.config
        data_seed = c["cohort_seed"]
        self.cohort = generate_cohort(seed=data_seed, **c["cohort"])
        self.train_seed = data_seed % (1 << 31)
        self.shards = federated_split(self.cohort.x_train, self.cohort.y_train,
                                      self.clients, self.train_seed)
        self.shard = max(x.shape[0] for x, _ in self.shards)
        t3 = time.perf_counter()
        self.pool = [experiment_inputs(self.seed, i, self.features,
                                       self.loops, self.clients, self.epochs,
                                       self.shard)
                     for i in range(self.pool_size)]
        t4 = time.perf_counter()
        self.train_cfg = TrainConfig(
            learning_rate=self.lr, global_loops=self.loops,
            local_epochs=self.epochs, local_batch_size=self.batch,
            seed=self.train_seed, eval_every=int(c["eval_every"]),
            scbf=ScbfConfig(upload_rate=self.rate, num_clients=self.clients),
            fed=FedConfig(engine=c["engine"],
                          fuse_rounds=int(c["fuse_rounds"])))
        self._install_tap()
        self.experiment()               # the warm-up: every shape once
        self.done.clear()
        # what set-up made lives to the end: out of the collector's way,
        # so the collection before each experiment scans only its garbage
        gc.collect()
        gc.freeze()
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t5 = time.perf_counter()
        self.split = {"imports": t1 - t_start, "device_init": t1b - t1,
                      "kernel_load": t2 - t1b,
                      "inputs": t3 - t2, "weights": t4 - t3,
                      "warm_up": t5 - t4}
        return self.split

    def _install_tap(self) -> None:
        """Wraps the engine's chunk (``run_fused_chunk``): the first
        chunk of each experiment leaves a copy of its weights (the state
        after its first ``fuse_rounds`` loops) and its uploads; a traced
        window opens before the second chunk and keeps every chunk's
        uploads while it is open."""
        cls = self.engine.BatchedEngine
        real = cls.run_fused_chunk
        drv = self

        def chunk(eng, method, params, plan, *a, **k):
            drv._chunks += 1
            if drv._chunks == 1:
                drv._t_first_chunk = time.perf_counter()
            if drv._chunks == 2 and drv._trace is not None:
                drv._trace()
            out = real(eng, method, params, plan, *a, **k)
            if drv._chunks == 1:
                drv._first = ([{n: v.clone() for n, v in layer.items()}
                               for layer in out[0]],
                              [payloads for payloads, _ in out[1]])
            if drv._emitted is not None:
                drv._emitted.append(out[1])
            return out
        cls.run_fused_chunk = chunk
        self._untap = lambda: setattr(cls, "run_fused_chunk", real)

    def experiment(self) -> dict:
        """One whole experiment, the pool's next inputs."""
        i = self.next_index
        self.next_index += 1
        ex = self.pool[i % len(self.pool)]
        self._first, self._chunks = None, 0
        # the last experiment's engine and captured graph are cyclic
        # garbage: collected here, never inside the next capture (torch
        # does not collect before a capture, and a graph destroyed while
        # another is captured invalidates that capture).  This and the
        # collector's pause in the window go once the program frees its
        # graph without the cyclic collector.
        t0 = time.perf_counter()
        gc.collect()
        t1 = time.perf_counter()
        res = self.scbf.run_federated(
            self.cohort, self.train_cfg, method=self.method,
            mlp_features=self.features, device=self.device,
            init_params=ex.params,
            perms=lambda loop, k, e, _p=ex.perms: _p[loop, k, e])
        params, uploads = self._first
        t2 = time.perf_counter()
        rec = {"index": i, "params": params, "uploads": uploads,
               "auc": res.records[-1].auc_roc,
               "walls": (t1 - t0, self._t_first_chunk - t1,
                         t2 - self._t_first_chunk)}
        self.done.append(rec)
        return rec

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        # garbage is collected between experiments (``experiment``), not
        # at whatever allocation crosses the collector's threshold
        gc.disable()
        try:
            t0 = time.perf_counter()
            while True:
                self.experiment()
                if time.perf_counter() - t0 >= seconds:
                    break
            wall = time.perf_counter() - t0
        finally:
            gc.enable()
        loops = self.loops * len(self.done)
        self.log("experiments (collect, to the first chunk, the chunks) s: "
                 + " ".join("%.3f/%.3f/%.3f" % r["walls"] for r in self.done))
        failed = sum(not np.isfinite(r["auc"]) for r in self.done)
        return {"metrics": {"loop_ms": 1e3 * wall / loops},
                "attempted": len(self.done), "failed": int(failed),
                "wall_s": wall, "loops": loops}

    def traced(self) -> dict:
        """The steady part of one experiment in a traced window: from its
        second chunk (the capture, in its first, is never traced) to its
        end, the evaluations and emissions with it; opened with a burst
        of the cell's own products and K1."""
        torch, scbf, graphs = self.torch, self.scbf, self.graphs
        from repro_torch.kernels.channel_norm import channel_norms_leaves
        g = torch.Generator(device=self.device).manual_seed(self.seed % 997)
        mats = [torch.randn(8, a, b, generator=g, device=self.device)
                for a, b in zip(self.features[:-1], self.features[1:])]

        def burst():
            for _ in range(3):
                channel_norms_leaves(mats)
                for m in mats:
                    torch.matmul(m.transpose(1, 2), m)

        tracer = Tracer(torch)
        real_eval = scbf._evaluate
        st: dict = {}

        def open_window():
            tracer.start(burst)
            st["before"], st["replays"] = launch_counts(), graphs.replays
            self._emitted = []

        def evaluate(*a, **k):
            if tracer.active:
                st["evaluations"] += 1
            return real_eval(*a, **k)

        def attempt():
            st["evaluations"] = 0
            self.experiment()
            w = tracer.stop()
            after = launch_counts()
            got = {k: after[k] - st["before"][k] for k in after
                   if k != "apoz"}
            st["rounds"] = graphs.replays - st["replays"]
            if self.method == "scbf":
                got["channel_norm"] += st["rounds"]
                got["select_mask"] += st["rounds"]
            return w, got

        self._trace = open_window
        scbf._evaluate = evaluate
        try:
            w = robust_window(attempt, log=self.log)
        finally:
            self._trace = None
            scbf._evaluate = real_eval
        emitted = self._emitted or []
        self._emitted = None
        compacted = sum(lp.nnz for out in emitted for payloads, _ in out
                        for p in payloads for lp in p.layers
                        if lp.codec in ("coo", "bitmap"))
        uploads = sum(len(payloads) for out in emitted
                      for payloads, _ in out)
        return {"window": w, "loops": st["rounds"], "attempted": 1,
                "evaluations": st["evaluations"], "method": self.method,
                "features": self.features, "shard": self.shard,
                "batch": self.batch, "epochs": self.epochs,
                "clients": self.clients,
                "test_rows": int(self.cohort.x_test.shape[0]),
                "uploads": uploads, "compacted": compacted}

    # ------------------------------------------------------------ check
    @staticmethod
    def host(rec: dict) -> dict:
        """An experiment's record with its first state on the host."""
        return dict(rec, params=[{k: v.detach().cpu().numpy()
                                  for k, v in layer.items()}
                                 for layer in rec["params"]])

    def as_got(self, index: int, run) -> dict:
        """A reference run (the control) in the program's place."""
        def host(layers):
            return [{k: v.cpu().numpy() for k, v in layer.items()}
                    for layer in layers]
        return {"index": index, "params": host(run.final),
                "uploads": [[host(up) for up in loop]
                            for loop in run.uploads]}

    def release(self) -> None:
        """Frees the program's state; keeps the experiment to check, one
        of the window's drawn from the seed."""
        self._untap()
        gc.unfreeze()
        rng = np.random.default_rng([self.seed, 3])
        self.sample = self.host(self.done[int(rng.integers(len(self.done)))])
        self.done.clear()
        if self.device == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, index: int, precision: str = "fp32"):
        """The reference's first chunk of loops of the pool's experiment
        ``index``."""
        from reference import mlp as ref
        ex = self.pool[index % len(self.pool)]
        return ref.run_experiment(
            self.shards, ex.params, ex.perms, self.method, self.fuse,
            self.lr, self.rate, self.batch, self.device, precision=precision)

    def readings(self, got: dict, ref, detail: bool = False) -> dict:
        """The numbers compared: ``got`` the program's (or the control's)
        experiment, ``ref`` the reference's first loops.  The change of
        the weights over the first chunk (the training measure: the worst
        leaf's gap of norms); SCBF's uploads of the first loop, read back
        from the wire, their values where both sides kept an entry: the
        worst client's gap, and the median client's (the clients of a
        loop train apart, so a rounding event such as a ReLU crossing in
        one client's SGD moves that client's upload alone, while a
        product in a lower precision moves every client's)."""
        ex = self.pool[got["index"] % len(self.pool)]

        def host(layers):
            return [{k: v.cpu().numpy() for k, v in layer.items()}
                    for layer in layers]
        want = host(ref.final)
        out = {"change_gap": compare.change_gap(ex.params, got["params"],
                                                want)}
        if self.method == "scbf":
            gaps = compare.upload_gaps(
                got["uploads"][0], [host(up) for up in ref.uploads[0]])
            out["upload_gap"] = max(gaps)
            out["upload_median_gap"] = float(np.median(gaps))
        if detail:
            out["leaves"] = [
                [k, compare.norm(np.asarray(a[k], np.float64) - s[k]),
                 compare.norm(np.asarray(b[k], np.float64) - s[k])]
                for s, a, b in zip(ex.params, got["params"], want)
                for k in sorted(s)]
        return out

    def check(self) -> Dict[str, float]:
        return self.readings(self.sample, self.reference(self.sample["index"]))
