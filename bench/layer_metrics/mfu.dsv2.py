"""mfu.dsv2: the traced steps' algorithm FLOPs over their window and the
card's published bf16 dense peak, in percent.  A token costs 6 FLOPs a
dense parameter (every weight matrix but the routed expert stacks: the
q-lora query, the latent, the dense MLP, the shared experts, the router
and the head; the embedding not at all) plus causal attention's products;
the held experts cost 6 × 3 × d_model × expert width a routed slot they
kept (the MoE layers' slot counter, dropped slots not counted);
remat's recompute not counted (``harness/work_dsv2.step_flops``)."""
from harness import work, work_dsv2


def read(ctx):
    if "routed_slots" not in ctx:
        return None
    a = ctx["arch"]
    kept = ctx["routed_slots"] - ctx["dropped_slots"]
    flops = ctx["steps"] * work_dsv2.step_flops(
        [(n, s) for n, s, _ in ctx["leaves"]], ctx["tokens_per_step"],
        ctx["seq"], a.num_layers, a.num_heads, a.head_dim + a.qk_rope_dim,
        a.head_dim, a.d_model, a.d_ff, kept)
    peak = work.peaks(ctx["kind"])["bf16_flop_s"]
    return 100.0 * flops / (ctx["window"].window_s * peak)
