"""Synthetic medical cohort matching the paper's private dataset shape.

The port's own copy of ``repro.data.medical`` (host numpy, no JAX): the
same seed gives byte-identical arrays in both packages.

Paper §2.2: 30,760 admissions, 2,917 distinct medicines, binary feature =
"patient took medicine m after admission", binary label = mortality
(alive/expired).  60% train / 10% validation / 30% test; the training set
is split equally into 5 local client datasets.

The hospital data is private, so this module *simulates the data gate*:

* medicine popularity follows a power law (a few very common drugs, a
  long tail), mean ~7 medicines per admission — typical of EHR medication
  tables;
* mortality comes from a planted sparse logistic model: ~150 medicines
  carry non-zero risk weights (some protective, some high-risk — e.g.
  pressors / comfort-care drugs correlate strongly with death in real
  cohorts), plus a handful of pairwise interactions and label noise;
* the weight scale is calibrated so a small MLP reaches AUC-ROC ≈ 0.97-0.98,
  the paper's operating regime, making the SCBF-vs-FedAvg comparison
  meaningful.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


@dataclass
class MedicalCohort:
    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def num_features(self) -> int:
        return self.x_train.shape[1]


def generate_cohort(num_admissions: int = 30760,
                    num_medicines: int = 2917,
                    num_risk_medicines: int = 150,
                    num_interactions: int = 30,
                    mean_meds: float = 7.0,
                    label_noise: float = 0.01,
                    signal_scale: float = 3.0,
                    seed: int = 0) -> MedicalCohort:
    """Generate the synthetic cohort (numpy; this is a host-side pipeline)."""
    rng = np.random.default_rng(seed)

    # power-law medicine popularity, scaled to the target mean count
    pop = rng.pareto(1.2, size=num_medicines) + 1e-3
    pop = pop / pop.sum() * mean_meds
    pop = np.clip(pop, 0.0, 0.6)

    x = (rng.random((num_admissions, num_medicines)) < pop[None, :])
    x = x.astype(np.float32)

    # planted sparse logistic risk model — risk concentrates on *popular*
    # medicines (as in real EHR cohorts: pressors, opioids, comfort-care
    # drugs are both common and strongly mortality-associated), so the
    # signal actually fires on most admissions
    num_risk_medicines = min(num_risk_medicines, num_medicines // 2)
    risk_p = pop / pop.sum()
    risk_idx = rng.choice(num_medicines, size=num_risk_medicines,
                          replace=False, p=risk_p)
    w = np.zeros(num_medicines, dtype=np.float32)
    w[risk_idx] = rng.normal(0.0, 2.5, size=num_risk_medicines)

    logits = x @ w
    # pairwise interactions among risk medicines
    for _ in range(num_interactions):
        i, j = rng.choice(risk_idx, size=2, replace=False)
        coef = rng.normal(0.0, 3.0)
        logits += coef * x[:, i] * x[:, j]
    logits += rng.normal(0.0, 0.3, size=num_admissions)   # unobserved factors
    # center so mortality prevalence is realistic-ish but balanced enough
    # for stable AUC-PR (paper's AUC-PR ~0.97 implies a fairly balanced set)
    logits -= np.median(logits)
    # sharpen: push p towards 0/1 so the Bayes ceiling matches the paper's
    # ~0.98 AUC operating regime (label_noise below keeps it from being 1.0)
    logits *= signal_scale
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.random(num_admissions) < p).astype(np.float32)
    flip = rng.random(num_admissions) < label_noise
    y = np.where(flip, 1.0 - y, y)

    # 60 / 10 / 30 split (paper §2.2)
    perm = rng.permutation(num_admissions)
    n_train = int(0.6 * num_admissions)
    n_val = int(0.1 * num_admissions)
    tr, va, te = np.split(perm, [n_train, n_train + n_val])
    return MedicalCohort(
        x_train=x[tr], y_train=y[tr],
        x_val=x[va], y_val=y[va],
        x_test=x[te], y_test=y[te])


def federated_split(x: np.ndarray, y: np.ndarray, num_clients: int = 5,
                    seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Equally divide the training set into ``num_clients`` local sets."""
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(x.shape[0])
    n = (x.shape[0] // num_clients) * num_clients
    idx = np.split(perm[:n], num_clients)
    return [(x[i], y[i]) for i in idx]


def dirichlet_split(x: np.ndarray, y: np.ndarray, num_clients: int = 5,
                    alpha: float = 0.5, seed: int = 0,
                    min_per_client: int = 1
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Label-skew Dirichlet partition — heterogeneous hospital silos.

    For each label class, client shares are drawn from Dir(alpha·1_K)
    and the class's examples are dealt out accordingly: small ``alpha``
    gives strongly non-IID silos (each hospital dominated by one
    outcome), large ``alpha`` recovers ~IID.  Every training example is
    assigned to exactly one client (examples are conserved); shards are
    topped up from the largest shard so none ends below
    ``min_per_client``.
    """
    if num_clients < 1:
        raise ValueError("num_clients must be >= 1")
    rng = np.random.default_rng(seed + 1)
    y = np.asarray(y).reshape(-1)
    shards: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for c in np.unique(y):
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * idx.size).astype(np.int64)
        for k, part in enumerate(np.split(idx, cuts)):
            shards[k].append(part)
    parts = [np.concatenate(s) if s else np.array([], dtype=np.int64)
             for s in shards]
    # rebalance: extreme alpha can leave a client empty, which no real
    # deployment (and no padded cohort) can represent
    for k in range(num_clients):
        while parts[k].size < min_per_client:
            donor = int(np.argmax([p.size for p in parts]))
            parts[k] = np.append(parts[k], parts[donor][-1])
            parts[donor] = parts[donor][:-1]
    out = []
    for p in parts:
        rng.shuffle(p)
        out.append((x[p], y[p]))
    return out


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int,
                   seed: int = 0, shuffle: bool = True
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of minibatches (drops the ragged tail)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(x.shape[0]) if shuffle else np.arange(x.shape[0])
    for start in range(0, x.shape[0] - batch_size + 1, batch_size):
        sel = order[start:start + batch_size]
        yield x[sel], y[sel]
