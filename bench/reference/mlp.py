"""Plain reference of the paper's federated loop (Shao et al. 2019,
Algorithm 1; FedAvg as its baseline), in fp32 with TF32 off.

Written from the method, not from the program: one client at a time, a
hand-written backward pass of the 3-layer ReLU MLP, the channel scores
and the edge rule of SCBF's selection, the server's sum (SCBF) or
example-weighted average (FedAvg).  It takes the cohort, the initial
weights and the permutations that the benchmark made, and nothing that
the program made.  ``precision="tf32"`` runs the same arithmetic with
TF32 matrix products: the control that a sound comparison must fail.

Conventions it shares with the system it checks, each a statement of the
method rather than a choice of the program: the ragged tail of a shard is
dropped each epoch; the BCE-with-logits gradient at a logit of exactly 0
(an all-zero example through zero biases, at the first steps) is ``-y``,
the subgradient the system's loss takes there (``max`` split in halves,
``|z|`` of slope 1); ReLU's slope at 0 is 0; the quantile is linear
interpolation at position q·(n-1) in fp32; a channel is kept when its
score plus the best completion exceeds the threshold.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def matmul_precision(precision: str):
    """fp32 products with TF32 off, or (the control) with TF32 on."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def forward(params, x):
    """Logits (n,) and the pre-activations of the hidden layers."""
    pres, h = [], x
    for i, layer in enumerate(params):
        z = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            pres.append(z)
            h = torch.relu(z)
        else:
            h = z
    return h[:, 0], pres


def sgd_step(params, x, y, lr: float) -> None:
    """One SGD step on the mean BCE of the batch, in place."""
    n = x.shape[0]
    z, pres = forward(params, x)
    dz = torch.where(z == 0, -y, torch.sigmoid(z) - y) / n
    grads = [None] * len(params)
    d = dz[:, None]
    for i in range(len(params) - 1, -1, -1):
        h_in = x if i == 0 else torch.relu(pres[i - 1])
        grads[i] = {"w": h_in.T @ d, "b": d.sum(axis=0)}
        if i > 0:
            d = (d @ params[i]["w"].T) * (pres[i - 1] > 0)
    for layer, g in zip(params, grads):
        layer["w"] -= lr * g["w"]
        layer["b"] -= lr * g["b"]


def local_train(params, x, y, perms, batch: int, lr: float):
    """SGD over a client's shard, one permutation an epoch, full batches
    only; returns the trained weights."""
    p = [{k: v.clone() for k, v in layer.items()} for layer in params]
    n = (x.shape[0] // batch) * batch
    for perm in perms:
        idx = perm[:n].reshape(-1, batch)
        for b in range(idx.shape[0]):
            sgd_step(p, x[idx[b]], y[idx[b]], lr)
    return p


def quantile(values: torch.Tensor, q: float) -> torch.Tensor:
    """Linear interpolation at fp32 position q·(n-1) of the sorted
    values, weights 1 - frac and frac."""
    vals = torch.sort(values).values
    n = vals.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    lo = int(torch.clamp(torch.floor(pos), 0, n - 1))
    hi = int(torch.clamp(torch.ceil(pos), 0, n - 1))
    frac = (pos - torch.floor(pos)).to(vals.device)
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def select(delta, rate: float):
    """SCBF's selection of one client's delta: the masked delta.  A
    neuron's score is its column's squared norm plus its bias's square; a
    channel's is the sum of its neurons' scores; the threshold is the
    (1 - rate)-quantile of all channels'; an edge (p, q) of layer l is
    kept when its two neurons' scores plus the best scores of the other
    layers exceed it, a bias when its neuron's best channel does."""
    scores = [(g["w"] * g["w"]).sum(axis=0) + g["b"] * g["b"] for g in delta]
    total = torch.zeros((1,) * len(scores), dtype=torch.float32,
                        device=scores[0].device)
    for l, s in enumerate(scores):
        shape = [1] * len(scores)
        shape[l] = s.shape[0]
        total = total + s.reshape(shape)
    thr = quantile(total.reshape(-1), 1.0 - rate)
    maxes = [s.max() for s in scores]
    best = maxes[0]
    for m in maxes[1:]:
        best = best + m
    out = []
    for l, g in enumerate(delta):
        if l == 0:
            rest = best - maxes[0]
            keep_w = (scores[0][None, :] + rest) > thr
            keep_w = keep_w.expand_as(g["w"])
            keep_b = (scores[0] + rest) > thr
        else:
            rest = best - maxes[l - 1] - maxes[l]
            keep_w = (scores[l - 1][:, None] + scores[l][None, :]) + rest > thr
            keep_b = (maxes[l - 1] + scores[l]) + rest > thr
        out.append({"w": torch.where(keep_w, g["w"], 0.0),
                    "b": torch.where(keep_b, g["b"], 0.0)})
    return out


@dataclass
class Run:
    """What the reference computes of an experiment's first loops: each
    loop's uploads (SCBF: every client's selected delta) and the weights
    after them."""

    uploads: List[List[list]] = field(default_factory=list)
    final: list = None


def run_experiment(shards, params0: Sequence[dict], perms, method: str,
                   loops: int, lr: float, rate: float, batch: int, device,
                   precision: str = "fp32") -> Run:
    """The first ``loops`` federated loops from ``params0`` (numpy layers)
    over the clients' ``shards`` ((x, y) numpy), ``perms`` (loops,
    clients, epochs, shard); SCBF sums the clients' selected deltas,
    FedAvg averages the clients' weights by their examples."""
    run = Run()
    with matmul_precision(precision), torch.no_grad():
        xs = [(torch.as_tensor(x, device=device),
               torch.as_tensor(y, device=device)) for x, y in shards]
        params = [{k: torch.as_tensor(v, device=device) for k, v in
                   layer.items()} for layer in params0]
        counts = np.array([x.shape[0] for x, _ in shards], np.float64)
        weights = (counts / counts.sum()).astype(np.float32)
        for loop in range(loops):
            acc = [{k: torch.zeros_like(v) for k, v in layer.items()}
                   for layer in params]
            run.uploads.append([])
            for k, (x, y) in enumerate(xs):
                perm = torch.as_tensor(perms[loop, k], device=device)
                local = local_train(params, x, y, perm, batch, lr)
                if method == "scbf":
                    delta = [{n: local[l][n] - params[l][n] for n in local[l]}
                             for l in range(len(params))]
                    up = select(delta, rate)
                    run.uploads[-1].append(up)
                else:
                    up = [{n: v * float(weights[k]) for n, v in layer.items()}
                          for layer in local]
                for a, u in zip(acc, up):
                    for n in a:
                        a[n] += u[n]
            if method == "scbf":
                params = [{n: p[n] + a[n] for n in p}
                          for p, a in zip(params, acc)]
            else:
                params = acc
        run.final = params
    return run
