"""encode_wait_ms.mlp: host ms a loop in the ``encode.wait`` span
(``comm/wire._encode_slots``' first read of the counts): the host blocked
on the chunk's device work, so how far the device runs behind the host;
clipped to the traced window."""
from harness import spans


def read(ctx):
    return spans.per_loop_ms(ctx, "encode.wait")
