"""APoZ counts and the per-batch APoZ scorer (port of
``repro.kernels.apoz``).

    counts[j] = #{b : acts[b, j] == 0}        APoZ = counts / B

``apoz_counts`` dispatches on the tensor's device: a CPU tensor goes to
``apoz_counts_plain``; a CUDA tensor launches the hand-written Hopper
kernel (``csrc/apoz.cu``) or raises.  ``launches`` counts kernel launches
only.  The reference takes its Pallas kernel only when ``B % 512 == 0``
and ``N % 256 == 0`` and a ``jnp`` mean otherwise; the port takes the
kernel for every CUDA shape: count · fl(1/B), which both of the
reference's branches compute, is the same number either way.

The reference's jit-cache hooks (``apoz_scorer_compile_count``) have no
counterpart: PyTorch runs eagerly and compiles nothing per shape.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.models.mlp_net import mlp_activations

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def apoz_counts_plain(acts: torch.Tensor) -> torch.Tensor:
    """(N,) int32 count of exact zeros per column of acts (B, N)."""
    return torch.count_nonzero(acts == 0, dim=0).to(torch.int32)


def _check(acts: torch.Tensor) -> None:
    if acts.ndim != 2 or acts.shape[0] == 0 or acts.shape[1] == 0:
        raise ValueError(f"apoz_counts takes a non-empty (B, N) matrix, got "
                         f"shape {tuple(acts.shape)}")
    if acts.dtype != torch.float32:
        raise TypeError(f"apoz_counts takes fp32 activations, got "
                        f"{acts.dtype}")
    if not acts.is_contiguous():
        raise ValueError("apoz_counts takes a contiguous (row-major) matrix")
    if acts.shape[0] > 65535 * 128:
        raise ValueError(f"apoz_counts takes at most {65535 * 128} rows a "
                         f"call, got {acts.shape[0]}")


def apoz_counts(acts: torch.Tensor) -> torch.Tensor:
    """(N,) int32 count of exact zeros per column of acts (B, N) fp32.

    ``-0.0`` counts as a zero and NaN does not (IEEE ``== 0``).  CUDA:
    the kernel, exact (integer atomics).
    """
    global launches
    _check(acts)
    if acts.device.type == "cpu":
        return apoz_counts_plain(acts)
    if acts.device.type != "cuda":
        raise ValueError(f"apoz_counts runs on cpu or cuda, not "
                         f"{acts.device}")
    lib = build.libraries()["apoz"]
    b, n = acts.shape
    counts = torch.empty((n,), dtype=torch.int32, device=acts.device)
    stream = torch.cuda.current_stream(acts.device).cuda_stream
    build.check(lib.apoz_counts_launch(acts.data_ptr(), b, n,
                                       counts.data_ptr(), stream),
                "apoz_counts kernel launch")
    launches += 1
    return counts


def apoz_batch_fractions(params: Sequence[dict], xb: torch.Tensor,
                         neuron_masks: Optional[Sequence[torch.Tensor]]
                         = None) -> List[torch.Tensor]:
    """Per-hidden-layer exact-zero fractions (fp32, (H_l,)) of one
    validation batch, bitwise the reference's scorer: count · fl(1/B)
    in fp32 — XLA compiles the reference's ``count / B`` and ``jnp.mean``
    alike into a multiply by the fp32 reciprocal, which differs from a
    true division in the last bit for most B.  ``neuron_masks``
    (mask-mode SCBFwP) zeroes pruned neurons, whose fraction is then
    B · fl(1/B) ≈ 1."""
    recip = float(np.float32(1.0) / np.float32(xb.shape[0]))
    with torch.no_grad():
        acts = mlp_activations(params, xb, neuron_masks)
        return [apoz_counts(a.contiguous()).to(torch.float32) * recip
                for a in acts]
