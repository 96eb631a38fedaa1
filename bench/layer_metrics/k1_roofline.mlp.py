"""k1_roofline.mlp: K1 (``kernels/channel_norm``) on a round's slot table
of the clients' deltas: the algorithm's bytes (``harness.work.
k1_mlp_bytes``, the real clients only) over 3.35 TB/s, over the device
time of K1's kernel events, in percent.  Nothing when the traced window
lost kernel events or held no K1."""
from harness import work
from harness.trace import KERNEL_EVENTS


def read(ctx):
    w = ctx["window"]
    n, secs = w.time_of(KERNEL_EVENTS["channel_norm"])
    if not w.info.get("complete") or n == 0:
        return None
    nbytes = n * work.k1_mlp_bytes(ctx["features"], ctx["clients"])
    return work.roofline_share(nbytes, 0.0, secs, ctx["kind"])
