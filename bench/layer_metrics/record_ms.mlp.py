"""record_ms.mlp: host ms a loop of the loops' records (``run_federated``'s
``_record``: byte accounting, the record and the ``round`` event): the
``record`` span less the ``eval`` spans inside it, clipped to the traced
window."""
from harness import spans


def read(ctx):
    return spans.per_loop_ms(ctx, "record", self_time=True)
