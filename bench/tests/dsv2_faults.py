"""Faults planted in the DeepSeek-V2 step's timed path, each one that the
``dsv2_fedstep`` cell's comparison must catch: the program's state left
unchanged and half of every batch left out (``bench_faults``' LM faults),
the q-lora RMSNorm dropped, the gates renormalised to sum to 1 instead of
scaled by ``router_scale``, and the router's group limit ignored.  Each is
a context manager that swaps a module attribute of the program and puts
it back."""
from __future__ import annotations

import contextlib
import dataclasses

from bench_faults import _swapped
from bench_faults import planted as lm_planted

FAULTS = ("unchanged", "half_batch", "q_norm_dropped", "gates_renormalised",
          "group_limit_ignored")


def _select_with(**changes):
    def swap(real):
        def select(probs, k, cfg=None):
            return real(probs, k, None if cfg is None else
                        dataclasses.replace(cfg, **changes))
        return select
    return swap


def planted(fault: str):
    """The fault ``fault`` planted in the step ("sound": none)."""
    if fault == "sound":
        return contextlib.nullcontext()
    if fault in ("unchanged", "half_batch"):
        return lm_planted("lm_fedstep", fault)
    from repro_torch.models import layers, moe
    if fault == "q_norm_dropped":
        def no_norm(real):
            def query(p, x):
                if "q" in p:
                    return real(p, x)
                return layers._dense(p["q_b"], layers._dense(p["q_a"], x))
            return query
        return _swapped(layers, "_query", no_norm)
    if fault == "gates_renormalised":
        return _swapped(moe, "_select", _select_with(router_norm_topk=True,
                                                     router_scale=1.0))
    if fault == "group_limit_ignored":
        return _swapped(moe, "_select", _select_with(router_expert_groups=1))
    raise ValueError(f"no fault {fault!r}")
