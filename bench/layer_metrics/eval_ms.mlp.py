"""eval_ms.mlp: host ms a loop in the ``eval`` span
(``core/scbf._evaluate``: the test set's forward pass, AUC-ROC and AUC-PR
through their host copy), clipped to the traced window."""
from harness import spans


def read(ctx):
    return spans.per_loop_ms(ctx, "eval")
