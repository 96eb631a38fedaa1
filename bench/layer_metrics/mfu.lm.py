"""mfu.lm: the traced steps' algorithm FLOPs over their window and the
card's published bf16 dense peak, in percent.  A token costs 6 FLOPs an
active parameter (``harness.work.lm_active_params`` from the leaf
shapes: routed experts at top-k of their count, the embedding not at
all) plus causal attention's products; remat's recompute not counted."""
from harness import work


def read(ctx):
    a = ctx["arch"]
    active = work.lm_active_params(
        [(n, s) for n, s, _ in ctx["leaves"]], a.num_experts,
        a.experts_per_token)
    attention = work.lm_attention_flops_per_token(
        a.num_layers, a.num_heads, a.head_dim + a.qk_rope_dim, a.head_dim,
        ctx["seq"])
    flops = ctx["steps"] * ctx["tokens_per_step"] * \
        work.lm_flops_per_token(active, attention)
    peak = work.peaks(ctx["kind"])["bf16_flop_s"]
    return 100.0 * flops / (ctx["window"].window_s * peak)
