"""Token batches for the LM cells, made from the seed: a frozen copy of
the program's synthetic Markov token stream (``repro_torch.data.tokens``),
each batch ``(clients, batch, seq)`` int32 ids and next-token targets.
Plain numpy; nothing of the program."""
from __future__ import annotations

from typing import Dict

import numpy as np


def markov_batch(rows: int, seq: int, vocab: int, rng) -> Dict[str, np.ndarray]:
    """``rows`` sequences: token t+1 = (31·t + 17) mod vocab w.p. 0.8,
    else uniform; targets are the tokens shifted by one."""
    a, b = 31, 17
    toks = np.empty((rows, seq + 1), dtype=np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=rows)
    follow = rng.random((rows, seq)) < 0.8
    noise = rng.integers(0, vocab, size=(rows, seq))
    for t in range(seq):
        det = (toks[:, t] * a + b) % vocab
        toks[:, t + 1] = np.where(follow[:, t], det, noise[:, t])
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def batch_pool(seed: int, size: int, clients: int, batch: int, seq: int,
               vocab: int) -> list:
    """``size`` distinct batches, each {"tokens", "targets"} of shape
    (clients, batch, seq), batch i from (seed, 2, i)."""
    out = []
    for i in range(size):
        rng = np.random.default_rng([seed, 2, i])
        nb = markov_batch(clients * batch, seq, vocab, rng)
        out.append({k: v.reshape(clients, batch, seq) for k, v in nb.items()})
    return out
