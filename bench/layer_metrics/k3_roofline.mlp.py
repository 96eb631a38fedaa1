"""k3_roofline.mlp: K3 (select_compact, its count and scatter passes) on
the emissions of a traced experiment: the algorithm's bytes
(``harness.work.k3_mlp_bytes``: every upload's entries read once, the
kept entries of the coo and bitmap leaves written as index and value)
over 3.35 TB/s, over the device time of both passes' kernel events, in
percent.  Nothing when the traced window lost kernel events."""
from harness import work
from harness.trace import KERNEL_EVENTS


def read(ctx):
    w = ctx["window"]
    n1, s1 = w.time_of(KERNEL_EVENTS["select_compact_count"])
    _, s2 = w.time_of(KERNEL_EVENTS["select_compact_scatter"])
    if not w.info.get("complete") or n1 == 0:
        return None
    nbytes = work.k3_mlp_bytes(ctx["features"], ctx["uploads"],
                               ctx["compacted"])
    return work.roofline_share(nbytes, 0.0, s1 + s2, ctx["kind"])
