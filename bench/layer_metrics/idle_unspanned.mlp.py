"""idle_unspanned.mlp: the share of the traced window's idle time (%)
whose gaps lie, by their middle, under none of the program's spans
(``harness/spans.PROGRAM_SPANS``): the idle time the spans cannot name.
A window without the program's spans reads 100."""
from harness import spans


def read(ctx):
    return spans.idle_unspanned(ctx["window"])
