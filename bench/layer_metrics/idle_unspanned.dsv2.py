"""idle_unspanned.dsv2: the share of the traced window's idle time (%)
whose gaps lie, by their middle, under none of the device-side extents of
the step's spans (``drivers/dsv2_fedstep.SPANS``): the idle time the
spans cannot name, the gaps around the window's opening burst among it.
Nothing when the window holds none of the spans."""
from harness.device_spans import idle_unspanned


def read(ctx):
    return idle_unspanned(ctx["window"])
