"""Faults planted in the timed path, each one that a cell's comparison
must catch: the program's state left unchanged by a step, half of every
batch left out (the mean taken over the rest), and an upload altered
where it is produced.  Each is a context manager that swaps a module
attribute of the program and puts it back."""
from __future__ import annotations

import contextlib

import numpy as np



def faults_for(cell) -> tuple:
    """The faults a cell can have: FedAvg ships whole weights from inside
    its captured round, so its uploads are not altered apart."""
    if cell.spec["driver"] == "lm_fedstep":
        return ("unchanged", "half_batch")
    if cell.traffic["method"] == "fedavg":
        return ("unchanged", "half_batch")
    return ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _swapped(module, name: str, fn):
    real = getattr(module, name)
    setattr(module, name, fn(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def planted(driver: str, fault: str):
    """The fault ``fault`` planted in ``driver``'s timed path ("sound":
    none)."""
    import torch
    if fault == "sound":
        return contextlib.nullcontext()
    if driver == "mlp_federated":
        from repro_torch.comm import wire
        from repro_torch.core import client
        from repro_torch.fed import engine
        if fault == "unchanged":
            stack = contextlib.ExitStack()
            same = (lambda real: lambda params, *a, **k: tuple(
                {n: v.clone() for n, v in layer.items()} for layer in params))
            stack.enter_context(_swapped(engine, "scbf_sum_step", same))
            stack.enter_context(_swapped(engine, "fedavg_step", same))
            return stack
        if fault == "half_batch":
            def half(real):
                def per_example(logits, labels):
                    per = real(logits, labels)
                    n = per.shape[-1]
                    first = torch.arange(n, device=per.device) < n // 2
                    return torch.where(first, 2.0 * per, 0.0)
                return per_example
            return _swapped(client, "bce_elementwise", half)
        if fault == "altered":
            def altered(real):
                def encode(*a, **k):
                    payloads = real(*a, **k)
                    for lp in payloads[0].layers:
                        np.negative(lp.values, out=lp.values)
                    return payloads
                return encode
            return _swapped(wire, "encode_round", altered)
    if driver == "lm_fedstep":
        from repro_torch.core import distributed as dist
        if fault == "unchanged":
            return _swapped(dist, "_sum_and_update",
                            lambda real: lambda params, *a, **k: params)
        if fault == "half_batch":
            def half(real):
                def grads(loss_fn, params, batch):
                    rows = next(iter(batch.values())).shape[1]
                    return real(loss_fn, params, {
                        k: v[:, :rows // 2] for k, v in batch.items()})
                return grads
            return _swapped(dist, "client_gradients", half)
    raise ValueError(f"no fault {fault!r} for {driver}")
