"""shapelint policy + rule catalogue (SL001–SL006) for the port.

The shape engine (``repro_torch.analysis.shapes``) is generic; this
module pins it to the port's padding architecture: which calls mint
arrays with dead slots, which objects carry the padding facts on
attributes, and which consumers are the sanctioned slot-axis reducers.

The port's dead-slot sources:

* bucketed-P cohort padding: ``cohort.bucket_size`` picks the bucket
  capacity ``B ≥ p_count``; ``fed/engine.BatchedEngine._slot_inputs``
  fills the tail slots with slot 0's row and the identity permutation,
  ``_stack_perms`` / ``_stack_params`` / ``cohort.pad_clients`` pad the
  plan's tables and the cohort's shards;
* the fixed 8-slot chunks: ``fed/engine._train_slots`` trains a round
  padded to a multiple of ``slots.SLOT_CHUNK`` and ``slots.slot_chunked``
  runs a slot-stacked product in whole chunks, so their results carry
  the round's dead slots;
* fused ``(S, B)`` horizon plans: ``prepare_fused_plan`` /
  ``horizon_slot_plan`` bake per-round participant tables whose
  ``part_idx`` legs are padded, ``weights`` legs are exact zeros at
  dead slots, and ``valid`` legs are the validity masks;
* keep-masks: mask-mode pruning ships full-geometry tensors with dead
  channels, consumed through the same masked reductions;
* fault-admit masks: the server admission gate intersects ``valid``
  with a per-round ``admit`` mask.

Rule catalogue
--------------
SL001  reduction (``sum/mean/max/…``) over an axis carrying padded
       slots with no dominating validity mask — garbage filler values
       enter the aggregate.
SL002  mean/division whose denominator counts padded slots — the
       "mean over B instead of Σvalid" bug: a correctly-masked sum
       divided by the bucket capacity instead of the valid count.
SL003  silent dtype promotion / float64 drift inside capture-reachable
       code — ``np.float64``, ``.double()``, ``.to(torch.float64)``,
       ``dtype=torch.float64`` creation, or f32×f64 arithmetic.
       Host-side accounting is exempt (``in_trace`` only).
SL004  boolean mask used arithmetically without an explicit cast —
       ``torch.sum(valid)`` relies on implicit bool→int promotion.
SL005  rank-changing broadcast between a padded and an unpadded
       tensor — padding provenance silently widens to the result.
SL006  nonfinite-producing op (``log/sqrt/÷``) on a maskable quantity
       without a dominating positive guard — the all-slots-masked
       round produces inf/nan.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set

from repro_torch.analysis import astgraph, shapes
from repro_torch.analysis.report import Finding

SHAPE_RULES = {
    "SL001": "reduction over a padded axis without a validity mask",
    "SL002": "mean/division whose denominator counts padded slots",
    "SL003": "silent dtype promotion / float64 drift in capture-reachable "
             "code",
    "SL004": "boolean mask used arithmetically without an explicit cast",
    "SL005": "rank-changing broadcast between padded and unpadded arrays",
    "SL006": "nonfinite-producing op on a maskable quantity without a guard",
}

POLICY = shapes.ShapePolicy(
    # -- dead-slot producers -------------------------------------------
    # slot stacks whose tail slots are filler: the round's bucket
    # padding and the 8-slot chunks
    padded_producers=("_slot_inputs", "_stack_perms", "_stack_params",
                      "pad_clients", "_train_slots", "slot_chunked"),
    # opaque plan makers whose attributes carry the facts below
    plan_producers=("horizon_slot_plan", "plan_horizon",
                    "prepare_fused_plan"),
    # scalar bucket capacities: count all slots incl. dead ones
    pad_count_producers=("cohort.bucket_size", "bucket_size",
                         "round_slots", "fused_num_slots"),
    # -- plan attribute / payload-key tables ---------------------------
    padded_attrs=("part_idx",),
    zeroed_attrs=("weights",),
    mask_attrs=("valid", "admit"),
    # parameter names that are validity masks even when no caller is
    # visible to the fixpoint (entry points, captured bodies)
    mask_params=("valid", "admit", "admit_mask", "keep_mask"),
    # slice bounds that restore the live prefix: `losses[:p_count]`
    count_names=("p_count", "n_valid"),
    # -- sanctioned slot-axis consumers --------------------------------
    # these functions own the masked-reduction idiom; their *results*
    # are provenance-free (their bodies are still analyzed)
    slot_reducers=("scbf_sum_step", "fedavg_step", "fedbuff_step",
                   "reduce_slots", "fedavg_metrics", "slot_metrics",
                   "masked_quantile", "_emit", "emit_fused_payloads"),
    # -- denominators that are zero by construction (SL006) ------------
    zero_risk_denoms=("decay_steps",),
)


def run_shape_rules(graph: astgraph.CallGraph,
                    rules: Optional[Sequence[str]] = None,
                    ) -> List[Finding]:
    """Run the shape fixpoint + SL rule checks over ``graph``."""
    selected: Optional[Set[str]] = None
    if rules is not None:
        selected = set(rules)
        unknown = selected - set(SHAPE_RULES)
        if unknown:
            raise ValueError(
                f"unknown shape rule(s): {', '.join(sorted(unknown))} "
                f"(known: {', '.join(sorted(SHAPE_RULES))})")
    analysis = shapes.ShapeAnalysis(graph, POLICY, rules=selected)
    return analysis.run()
