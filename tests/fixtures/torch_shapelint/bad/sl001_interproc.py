"""BAD (SL001, interprocedural): the padded slot stack is reduced by a
helper in ANOTHER module; the finding must land inside
``reduce_helper.total`` — padding provenance crossed the module
boundary via the call-site → parameter propagation."""
from bad.reduce_helper import total


def _train_slots(losses, b):
    """Producer stub with the 8-slot-chunk trainer's name and contract."""
    return losses


def loss_via_helper(losses, b):
    padded = _train_slots(losses, b)
    return total(padded)
