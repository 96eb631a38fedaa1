"""BAD (PL001, interprocedural): the dense delta is routed through a
helper in ANOTHER module; the finding must land inside
``leak_helper.ship_update`` — taint crossed the module boundary via
the call-site → parameter propagation."""
from bad.leak_helper import ship_update
from repro_torch.core.client import client_delta, local_train_slots


def upload_via_helper(params, x, y, lr, perms, ops, num):
    new_p = local_train_slots(tuple(params), x, y, lr, perms)
    delta = client_delta(tuple(params), new_p)
    return ship_update(delta, ops, num)
