"""BAD (PL001): the clients' dense slot-stacked deltas ship to the wire
un-selected and un-noised — the server would see the exact per-client
update."""
from repro_torch.comm import wire
from repro_torch.core.client import client_delta, local_train_slots


def upload_round(params, x, y, lr, perms, ops, num):
    new_p = local_train_slots(tuple(params), x, y, lr, perms)
    delta = client_delta(tuple(params), new_p)
    return wire.encode_round(tuple(delta), ops, num)
