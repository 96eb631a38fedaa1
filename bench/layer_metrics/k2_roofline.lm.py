"""k2_roofline.lm: K2 in place (``kernels/select_mask``) on the step's leaf tables
(every scored leaf as K clients' matrices, one table a dtype): the
algorithm's bytes (``harness.work.k2_lm_bytes``) over 3.35 TB/s, over the
device time of K2's kernel events, in percent.  Nothing when the traced
window lost kernel events."""
from harness import work
from harness.trace import KERNEL_EVENTS


def read(ctx):
    w = ctx["window"]
    n, secs = w.time_of(KERNEL_EVENTS["select_mask"])
    if not w.info.get("complete") or n == 0:
        return None
    t = work.lm_score_tables(ctx["leaves"], ctx["clients"])
    nbytes = ctx["steps"] * work.k2_lm_bytes(list(t.values()), list(t))
    return work.roofline_share(nbytes, 0.0, secs, ctx["kind"])
