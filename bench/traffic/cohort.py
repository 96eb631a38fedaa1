"""The paper's cohort and its federated inputs, made from the seed.

``generate_cohort`` and ``federated_split`` are frozen copies of the
program's synthetic cohort (``repro_torch.data.medical``), so the inputs
do not change when the program does; ``experiment_inputs`` draws what one
30-loop experiment starts from: the He-initialised weights and every
client's epoch permutations.  Plain numpy; nothing of the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class Cohort:
    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def num_features(self) -> int:
        return self.x_train.shape[1]


def generate_cohort(num_admissions: int = 30760, num_medicines: int = 2917,
                    num_risk_medicines: int = 150, num_interactions: int = 30,
                    mean_meds: float = 7.0, label_noise: float = 0.01,
                    signal_scale: float = 3.0, seed: int = 0) -> Cohort:
    """Binary medication features with power-law popularity and a planted
    sparse logistic mortality model; 60 / 10 / 30 split (paper §2.2)."""
    rng = np.random.default_rng(seed)
    pop = rng.pareto(1.2, size=num_medicines) + 1e-3
    pop = pop / pop.sum() * mean_meds
    pop = np.clip(pop, 0.0, 0.6)
    x = (rng.random((num_admissions, num_medicines)) < pop[None, :])
    x = x.astype(np.float32)
    num_risk_medicines = min(num_risk_medicines, num_medicines // 2)
    risk_p = pop / pop.sum()
    risk_idx = rng.choice(num_medicines, size=num_risk_medicines,
                          replace=False, p=risk_p)
    w = np.zeros(num_medicines, dtype=np.float32)
    w[risk_idx] = rng.normal(0.0, 2.5, size=num_risk_medicines)
    logits = x @ w
    for _ in range(num_interactions):
        i, j = rng.choice(risk_idx, size=2, replace=False)
        coef = rng.normal(0.0, 3.0)
        logits += coef * x[:, i] * x[:, j]
    logits += rng.normal(0.0, 0.3, size=num_admissions)
    logits -= np.median(logits)
    logits *= signal_scale
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.random(num_admissions) < p).astype(np.float32)
    flip = rng.random(num_admissions) < label_noise
    y = np.where(flip, 1.0 - y, y)
    perm = rng.permutation(num_admissions)
    n_train = int(0.6 * num_admissions)
    n_val = int(0.1 * num_admissions)
    tr, va, te = np.split(perm, [n_train, n_train + n_val])
    return Cohort(x_train=x[tr], y_train=y[tr], x_val=x[va], y_val=y[va],
                  x_test=x[te], y_test=y[te])


def federated_split(x: np.ndarray, y: np.ndarray, num_clients: int,
                    seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Equal IID shards (the ragged remainder of the training set left
    out), from ``seed + 1`` as the program splits its cohort."""
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(x.shape[0])
    n = (x.shape[0] // num_clients) * num_clients
    return [(x[i], y[i]) for i in np.split(perm[:n], num_clients)]


@dataclass
class Experiment:
    """One experiment's inputs: ``params`` a list of {"w", "b"} numpy
    layers, ``perms`` (loops, clients, epochs, shard) int64."""

    params: List[dict]
    perms: np.ndarray


def experiment_inputs(seed: int, index: int, features: Sequence[int],
                      loops: int, clients: int, epochs: int, shard: int
                      ) -> Experiment:
    """He-initialised weights with zero biases and every epoch's
    permutation of every client's shard, from (seed, index)."""
    rng = np.random.default_rng([seed, 1, index])
    params = []
    for fin, fout in zip(features[:-1], features[1:]):
        w = (rng.standard_normal((fin, fout), dtype=np.float32)
             * np.float32(np.sqrt(2.0 / fin)))
        params.append({"w": w, "b": np.zeros(fout, np.float32)})
    perms = np.empty((loops, clients, epochs, shard), np.int64)
    for loop in range(loops):
        for k in range(clients):
            for e in range(epochs):
                perms[loop, k, e] = rng.permutation(shard)
    return Experiment(params=params, perms=perms)
