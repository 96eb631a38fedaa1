"""The clients' sum and the SGD step of one leaf in one pass
(``csrc/sum_sgd.cu``), the port's own kernel: it replaces no TPU kernel,
since the reference's sum and update are plain ``jnp``.

    new = sgd_leaf(p, Σ_k g[k], lr)

``g_slots`` holds the K slots of the leaf's gradient, (K, *p.shape): the
K clients' masked gradients of a one-device step, or a (1, ...) view of a
sum already made (the pods' all-reduced sum, the compressed exchange's
scatter-add).  The sum is accumulated in fp32 as ``torch.sum`` over the
slot axis accumulates it on the card — four partial sums from 0, slot k
in partial k % 4, added in order, which is the slot order below K = 5 —
and rounded once to the leaf's dtype, and the step is ``sgd_leaf``'s
fp32 multiply and subtraction, rounded once each, cast back: on the card
the kernel's result is bitwise ``sum_sgd_plain``'s for every leaf of two
or more entries.  (``torch.sum`` sums a one-entry leaf's slots across
threads, so there the two may part at K >= 3; no model has such a
leaf.)

CPU and meta tensors take the plain version (``launch.dryrun`` runs the
step on the meta device); a CUDA tensor launches the kernel or raises,
but for an empty leaf (an empty local shard), which needs no launch.
``launches`` counts kernel launches only.  The new param is a new tensor
(``torch.empty_like(p)``): callers hold the old params.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.models.model_zoo import sgd_leaf

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def sum_sgd_plain(p: torch.Tensor, g_slots: torch.Tensor,
                  lr: float) -> torch.Tensor:
    """``sgd_leaf(p, torch.sum(g_slots, 0), lr)``."""
    return sgd_leaf(p, torch.sum(g_slots, axis=0), lr)


def _check(p: torch.Tensor, g_slots: torch.Tensor) -> None:
    build.refuse_dtensor("sum_sgd", p, g_slots)
    if p.dtype not in DTYPES or g_slots.dtype != p.dtype:
        raise TypeError(f"sum_sgd takes fp32 or bf16 params and slots of "
                        f"the param's dtype, got {p.dtype} and "
                        f"{g_slots.dtype}")
    if g_slots.ndim != p.ndim + 1 or g_slots.shape[0] < 1 or \
            g_slots.shape[1:] != p.shape:
        raise ValueError(f"sum_sgd takes slots (K, *{tuple(p.shape)}) with "
                         f"K >= 1, got {tuple(g_slots.shape)}")
    if p.device != g_slots.device:
        raise ValueError(f"sum_sgd: the param is on {p.device}, the slots "
                         f"on {g_slots.device}")
    if not (p.is_contiguous() and g_slots.is_contiguous()):
        raise ValueError("sum_sgd takes a contiguous param and contiguous "
                         "slots")


def sum_sgd(p: torch.Tensor, g_slots: torch.Tensor,
            lr: float) -> torch.Tensor:
    """The new param ``sgd_leaf(p, Σ_k g_slots[k], lr)``, one launch on
    CUDA; ``p`` is left as it was."""
    global launches
    _check(p, g_slots)
    device = p.device
    if device.type in build.PLAIN_DEVICES:
        with build.plain_version():
            return sum_sgd_plain(p, g_slots, lr)
    if device.type != "cuda":
        raise ValueError(f"sum_sgd runs on cpu, meta or cuda, not {device}")
    out = torch.empty_like(p)
    if out.numel() == 0:
        return out
    lib = build.libraries()["sum_sgd"]
    build.check(lib.sum_sgd_launch(
        p.data_ptr(), g_slots.data_ptr(), out.data_ptr(), p.numel(),
        int(g_slots.shape[0]), float(lr), DTYPES[p.dtype],
        torch.cuda.current_stream(device).cuda_stream),
        "sum_sgd kernel launch")
    launches += 1
    return out
