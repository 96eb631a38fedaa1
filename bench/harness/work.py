"""The yardstick's arithmetic: the card's published peaks, and the work
the algorithm needs, counted from the configuration's shapes and never
from the implementation (so a later kernel is read against the same
work).  A share of a peak is this work over the measured time."""
from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM, dense rates without sparsity, at the
# full 700 W power limit
PEAKS = {"H100": {"fp32_flop_s": 67e12, "bf16_flop_s": 989e12,
                  "hbm_byte_s": 3.35e12}}


def peaks(kind: str) -> Dict[str, float]:
    """The published peaks of the card named ``kind``."""
    for tag, p in PEAKS.items():
        if tag in kind:
            return p
    raise KeyError(f"no published peaks for {kind!r}")


def roofline_share(nbytes: float, flops: float, seconds: float,
                   kind: str, dtype_peak: str = "fp32_flop_s") -> float:
    """Percent of the least time the card could take (the larger of the
    byte and the operation bound) over the measured ``seconds``."""
    p = peaks(kind)
    bound = max(nbytes / p["hbm_byte_s"], flops / p[dtype_peak])
    return 100.0 * bound / seconds


# ---------------------------------------------------------------------------
# The paper's MLP
# ---------------------------------------------------------------------------

def mlp_weights(features: Sequence[int]) -> int:
    """Weight entries of the MLP (the biases' work is not counted)."""
    return sum(a * b for a, b in zip(features[:-1], features[1:]))


def mlp_trained_rows(shard: int, batch: int, epochs: int, clients: int
                     ) -> int:
    """Examples a loop trains on: every client's full batches, each epoch
    (the ragged tail of a shard is dropped)."""
    return clients * (shard // batch) * batch * epochs


def mlp_loop_flops(features: Sequence[int], shard: int, batch: int,
                   epochs: int, clients: int) -> float:
    """A federated loop's training: forward and backward, 6 FLOPs a weight
    and trained example."""
    return 6.0 * mlp_weights(features) * mlp_trained_rows(
        shard, batch, epochs, clients)


def mlp_eval_flops(features: Sequence[int], rows: int) -> float:
    """One evaluation: a forward pass over ``rows`` examples."""
    return 2.0 * mlp_weights(features) * rows


def mlp_slot_table(features: Sequence[int], slots: int
                   ) -> Tuple[int, int]:
    """(entries, row + column entries) of a table of ``slots`` clients'
    weight matrices."""
    entries = slots * mlp_weights(features)
    edges = slots * sum(a + b for a, b in zip(features[:-1], features[1:]))
    return entries, edges


def k1_mlp_bytes(features: Sequence[int], slots: int) -> int:
    """K1 on a round's slot table: every fp32 entry read once, the fp32
    row and column norms written once."""
    entries, edges = mlp_slot_table(features, slots)
    return 4 * entries + 4 * edges


def k3_mlp_bytes(features: Sequence[int], slots: int, compacted: int
                 ) -> int:
    """K3 (its count and scatter passes) on an emission of ``slots``
    uploads: every fp32 entry read once, a count a (leaf, slot) and an
    int32 index and fp32 value a compacted entry (``compacted``, the kept
    entries of the coo and bitmap leaves these inputs give) written."""
    entries, _ = mlp_slot_table(features, slots)
    leaves = len(features) - 1
    return 4 * entries + 4 * leaves * slots + 8 * compacted


# ---------------------------------------------------------------------------
# The LM's federated step
# ---------------------------------------------------------------------------

def lm_active_params(leaves: Iterable[Tuple[str, Tuple[int, ...]]],
                     num_experts: int, top_k: int) -> float:
    """Parameters a token passes through, from the leaf shapes: every
    weight matrix in full, a routed expert stack (``moe.wi``, ``moe.wg``,
    ``moe.wo``, with an expert axis) at ``top_k`` of its ``num_experts``;
    the embedding (a lookup) and the norm scales (no product) not at
    all."""
    total = 0.0
    for name, shape in leaves:
        n = math.prod(shape)
        last = name.split(".")
        if last[-1] == "scale" or name.startswith("embed."):
            continue
        if "moe" in last and last[-1] in ("wi", "wg", "wo"):
            total += n * top_k / num_experts
        else:
            total += n
    return total


def lm_attention_flops_per_token(layers: int, heads: int, qk_dim: int,
                                 v_dim: int, seq: int) -> float:
    """Causal attention's products a token, forward and backward (3 × the
    forward): scores over ``qk_dim`` and the weighted values over
    ``v_dim``, against (seq + 1) / 2 keys on average."""
    return 3.0 * layers * 2.0 * heads * (qk_dim + v_dim) * (seq + 1) / 2.0


def lm_flops_per_token(active: float, attention: float) -> float:
    """6 FLOPs an active parameter a token (forward and backward; the
    backward's recompute under remat not counted), plus attention."""
    return 6.0 * active + attention


def lm_score_tables(leaves: Iterable[Tuple[str, Tuple[int, ...], object]],
                    clients: int) -> Dict[int, list]:
    """{itemsize: [(K, M, N)]}: every scored leaf (a client's part of two
    axes or more) as K clients' matrices of its flattened leading axes by
    its last, one table a dtype."""
    out: Dict[int, list] = {}
    for _, shape, dtype in leaves:
        if len(shape) < 2:
            continue
        out.setdefault(dtype.itemsize, []).append(
            (clients, math.prod(shape[:-1]), shape[-1]))
    return out


def k1_lm_bytes(tables: Sequence[Sequence[Tuple[int, int, int]]],
                itemsizes: Sequence[int]) -> int:
    """K1 on the step's leaf tables: ``tables`` a list of tables, each a
    list of (K, M, N) matrices, ``itemsizes`` each table's bytes an
    entry; every entry read once, the fp32 row and column norms
    written."""
    total = 0
    for table, item in zip(tables, itemsizes):
        for k, m, n in table:
            total += item * k * m * n + 4 * k * (m + n)
    return total


def k2_lm_bytes(tables: Sequence[Sequence[Tuple[int, int, int]]],
                itemsizes: Sequence[int]) -> int:
    """K2 in place on the step's leaf tables: every entry read and written
    once, the zero row scores (M fp32), the column scores (K·N fp32), the
    threshold and rest read, a count a (leaf, slot) written."""
    total = 0
    for table, item in zip(tables, itemsizes):
        for k, m, n in table:
            total += 2 * item * k * m * n + 4 * (m + k * n) + 4 * k
        if table:
            total += 4 * table[0][0] + 4
    return total
