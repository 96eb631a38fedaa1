"""privlint policy + rule catalogue (PL001–PL006) for the port.

The taint engine (``repro_torch.analysis.taint``) is generic; this
module pins it to the port's privacy architecture: which functions mint
sensitive values, which calls are the sanctioned sanitizer chain

    core/channels + core/selection (→ SELECTED)
      → privacy.gaussian_mechanism + RDP accounting (→ DP-NOISED)
      → comm.wire.encode_round / encode_selected / encode (→ WIRE)
      → strategy.*_step (server),

and which calls are sinks past the privacy boundary.  Patterns are
dotted-name *suffixes* matched on whole components, so
``"wire.encode_round"`` matches ``repro_torch.comm.wire.encode_round``
from any import alias but never ``Transformer.encode_round``.

The port trains a round as slot stacks (``core/client.local_train_slots``
under ``fed/engine._train_slots``) and an LM step a client at a time
(``core/distributed.client_gradients``); its noise is standard normals
drawn on ``torch.Generator``s (``privacy.draw_normals``), which
``gaussian_mechanism`` takes as its second argument ``noise``.

Rule catalogue
--------------
PL001  un-sanitized value reaches the wire encoder — a LOCAL/RAW value
       (dense delta, raw batch) would ship to the server un-noised.
PL002  noise ordering violation — ``gaussian_mechanism`` applied to an
       already-encoded or already-revealed value; the un-noised
       coordinates have left the boundary, noising after the fact is
       theatre.
PL003  randomness hygiene on the noise path — loop-invariant normals at
       a noise call, normals consumed twice, a generator re-seeded with
       a loop-invariant seed inside a loop, or one slot's normals
       replicated across slots.  Correlated noise across clients or
       rounds voids the accountant's independence assumption.
PL004  accounting skew — a DP-noised payload is emitted with no
       accountant update anywhere on its caller chain (ε/δ spend
       untracked), or one function updates the release ledger twice
       for one emission (budget double-counted).
PL005  reveal/keep mask widened after noising — the Gaussian noise was
       calibrated to the pre-widening reveal set, so the extra
       coordinates ship with zero noise budget (includes the
       mask-mode compacted-geometry path).
PL006  telemetry/checkpoint sink (``obs.trace.event``, the device
       metrics carry, ``LoopRecord``, ``ckpt.save_checkpoint``) receives
       a pre-DP per-client value — events.jsonl and checkpoints are
       outside the privacy boundary.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set

from repro_torch.analysis import astgraph, taint
from repro_torch.analysis.report import Finding

PRIV_RULES = {
    "PL001": "tainted value reaches the wire without the sanitizer chain",
    "PL002": "DP noise applied after encoding / to revealed coordinates",
    "PL003": "PRNG key reused across clients/rounds on the noise path",
    "PL004": "ε/δ accounting skipped or double-counted for a payload",
    "PL005": "reveal/keep mask widened after noising",
    "PL006": "telemetry/checkpoint sink receives pre-DP per-client values",
}

POLICY = taint.Policy(
    # -- sources -------------------------------------------------------
    # raw client examples/labels: the federated splitters and the
    # training split they cut (the validation split is the server's,
    # which SCBFwP's APoZ pass reads, and the test split the server's
    # evaluation set: neither is a client's)
    raw_sources=("dirichlet_split", "federated_split"),
    raw_attrs=("x_train", "y_train"),
    # per-client training artefacts: params, losses, dense deltas, the
    # batched engine's trained slot stacks, an LM client's gradients
    local_sources=("local_train", "local_train_impl",
                   "masked_local_train_impl", "local_train_slots",
                   "client_delta", "client_gradients"),
    # -- the sanctioned sanitizer chain --------------------------------
    selectors=("select_gradients", "apply_channel_mask",
               "mask_by_operands", "apply_factored_mask_slots",
               "apply_factored_mask"),
    noisers=("gaussian_mechanism",),
    encoders=("wire.encode", "wire.encode_leaf", "wire.encode_selected",
              "wire.encode_round", "wire.seal"),
    decoders=("wire.decode", "wire.decode_leaf"),
    # cohort-level reductions: only aggregates cross to host telemetry
    aggregators=("metrics.offload", "metrics.reduce_slots",
                 "_host_round_metrics", "_host_fedavg_metrics",
                 "pruner.step", "pruner.compact"),
    # collectives that carry every rank's inputs to the result
    carriers=("gather_slots", "all_gather_compact", "all_gather_ragged",
              "all_reduce_sum", "shard_sum", "shard_gather"),
    # scalar eval metrics computed on the server's own eval pass
    metric_fns=("auc_roc", "auc_pr"),
    # -- accounting (PL004) --------------------------------------------
    accountant_calls=("epsilon_for", "amplified_epsilon_for",
                      "rdp_to_dp"),
    ledger_name_fragment="releases",
    # -- sinks past the privacy boundary (PL006) -----------------------
    telemetry_sinks=("trace.event", "trace.count", "slot_metrics",
                     "fedavg_metrics", "FedAvgMetrics", "LoopRecord",
                     "save_checkpoint"),
    # -- randomness hygiene (PL003) ------------------------------------
    key_makers=("torch.Generator", "Generator", "manual_seed",
                "get_state", "set_state"),
    key_replicators=("broadcast_to", "tile", "repeat", "expand",
                     "expand_as", "repeat_interleave"),
    reseeders=("manual_seed",),
    noise_draws=("draw_normals", "draw_noise"),
    key_kwargs=("generator",),
    noise_arg="noise",
    # -- post-noise mask widening (PL005) ------------------------------
    wideners=("logical_or", "maximum", "bitwise_or", "concatenate", "cat",
              "append"),
    # shape-only constructors never carry data, and index draws (batch
    # permutations, the sampled quantile path's channels) carry none
    # and are not the noise's randomness
    clean_calls=("zeros", "ones", "zeros_like", "ones_like", "arange",
                 "eye", "full", "full_like", "empty", "empty_like",
                 "linspace", "new_zeros", "new_ones", "new_full",
                 "new_empty", "randperm", "randint", "multinomial"),
)


def run_privacy_rules(graph: astgraph.CallGraph,
                      rules: Optional[Sequence[str]] = None,
                      ) -> List[Finding]:
    """Run the taint fixpoint + PL rule checks over ``graph``."""
    selected: Optional[Set[str]] = None
    if rules is not None:
        selected = set(rules)
        unknown = selected - set(PRIV_RULES)
        if unknown:
            raise ValueError(
                f"unknown privacy rule(s): {', '.join(sorted(unknown))} "
                f"(known: {', '.join(sorted(PRIV_RULES))})")
    analysis = taint.TaintAnalysis(graph, POLICY, rules=selected)
    return analysis.run()
