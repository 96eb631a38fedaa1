"""Synthetic LM token pipeline (port of ``repro.data.tokens``: a copy,
numpy only) for the transformer launchers and tests.

Generates structured (learnable) token streams: a first-order Markov chain
over the vocabulary with a few high-probability transitions, so a small
LM's loss visibly decreases within a few hundred steps.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_lm_batch(batch: int, seq: int, vocab: int, seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    # sticky Markov structure: token t+1 = (t * a + b) mod vocab w.p. 0.8
    a, b = 31, 17
    toks = np.empty((batch, seq + 1), dtype=np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    follow = rng.random((batch, seq)) < 0.8
    noise = rng.integers(0, vocab, size=(batch, seq))
    for t in range(seq):
        det = (toks[:, t] * a + b) % vocab
        toks[:, t + 1] = np.where(follow[:, t], det, noise[:, t])
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class SyntheticTokenStream:
    """Infinite iterator of synthetic LM batches."""

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0):
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.seed = seed
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        out = synthetic_lm_batch(self.batch, self.seq, self.vocab,
                                 seed=self.seed + self._step)
        self._step += 1
        return out
