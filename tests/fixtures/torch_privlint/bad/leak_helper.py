"""Helper module for the interprocedural pair: encodes whatever it is
handed.  Harmless alone — the leak only exists at call sites that hand
it un-sanitized values (see pl001_interproc.py)."""
from repro_torch.comm import wire


def ship_update(update, ops, num):
    return wire.encode_round(tuple(update), ops, num)
