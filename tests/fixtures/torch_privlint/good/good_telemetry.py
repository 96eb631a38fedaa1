"""GOOD: telemetry receives only declared cohort-level aggregates, and
the DP-off selection-only upload (the paper's base SCBF) is allowed on
the wire — it makes no (ε, δ) claim.  Zero findings."""
from repro_torch.comm import wire
from repro_torch.core.client import client_delta, local_train_slots
from repro_torch.core.selection import select_gradients
from repro_torch.obs import metrics, trace


def selection_only_round(params, x, y, lr, perms, rate, gen, num):
    new_p, loss = local_train_slots(tuple(params), x, y, lr, perms,
                                    with_loss=True)
    delta = client_delta(tuple(params), new_p)
    masked, masks, _, ops = select_gradients(delta, rate, "magnitude",
                                             generator=gen)
    dm = metrics.offload(loss)
    trace.event("round", train_loss=dm["train_loss"])
    return wire.encode_round(tuple(masked), ops, num), dm
