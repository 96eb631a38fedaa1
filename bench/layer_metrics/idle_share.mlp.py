"""idle_share.mlp: the share of an experiment's traced steady loops (its
second chunk to its end, evaluations included) in which no
kernel or copy ran on the card (1 - the union of the device intervals
over the window), in percent."""


def read(ctx):
    w = ctx["window"]
    return 100.0 * (1.0 - w.busy_s() / w.window_s)
