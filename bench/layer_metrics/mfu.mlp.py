"""mfu.mlp: the traced loops' algorithm FLOPs over its window and
the card's published fp32 peak (TF32 off), in percent.  The work is
counted from the configuration's shapes (``harness.work``): 6 FLOPs a
weight and trained example (full batches only, padding not counted) and
2 a weight and test example an evaluation."""
from harness import work


def read(ctx):
    f = ctx["features"]
    flops = ctx["loops"] * work.mlp_loop_flops(
        f, ctx["shard"], ctx["batch"], ctx["epochs"], ctx["clients"]) + \
        ctx["evaluations"] * work.mlp_eval_flops(f, ctx["test_rows"])
    peak = work.peaks(ctx["kind"])["fp32_flop_s"]
    return 100.0 * flops / (ctx["window"].window_s * peak)
