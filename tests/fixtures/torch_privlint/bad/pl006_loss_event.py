"""BAD (PL006): the slots' per-client training losses written straight
to the event log — events.jsonl is outside the privacy boundary."""
from repro_torch.core.client import local_train_slots
from repro_torch.obs import trace


def train_and_log(params, x, y, lr, perms):
    new_p, loss = local_train_slots(tuple(params), x, y, lr, perms,
                                    with_loss=True)
    trace.event("client_done", loss=loss)
    return new_p
