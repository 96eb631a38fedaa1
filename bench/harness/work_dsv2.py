"""The algorithm's FLOPs of the DeepSeek-V2 SCBF step, in
``harness/work.py``'s style: counted from the configuration's leaf
shapes and the routed slots the held experts computed (the MoE layer's
counter of kept slots), never from the implementation."""
from __future__ import annotations

from typing import Iterable, Tuple

from harness import work


def dense_params(leaves: Iterable[Tuple[str, Tuple[int, ...]]]) -> float:
    """Parameters every token passes through: ``work.lm_active_params``
    with the routed expert stacks left out (they are counted by slot)."""
    return work.lm_active_params(leaves, num_experts=1, top_k=0)


def step_flops(leaves: Iterable[Tuple[str, Tuple[int, ...]]],
               tokens: int, seq: int, layers: int, heads: int,
               qk_dim: int, v_dim: int, d_model: int, expert_width: int,
               kept_slots: float) -> float:
    """A federated step's forward and backward FLOPs: 6 a dense
    parameter a token, causal attention's products a token (queries and
    keys ``qk_dim`` wide, values ``v_dim``: MLA's q-lora shapes are in the
    leaves), and 6 × 3 × d_model × expert_width a routed slot a held
    expert kept (its SwiGLU's three products).  ``tokens`` and
    ``kept_slots`` are the step's, over every client."""
    attention = work.lm_attention_flops_per_token(layers, heads, qk_dim,
                                                  v_dim, seq)
    per_token = work.lm_flops_per_token(dense_params(leaves), attention)
    return tokens * per_token + 18.0 * d_model * expert_width * kept_slots
