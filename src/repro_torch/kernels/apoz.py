"""APoZ counts and the per-batch APoZ scorer (port of
``repro.kernels.apoz``).

    counts[j] = #{b : acts[b, j] == 0}        APoZ = counts · fl(1/B)

A validation batch is one *leaf table*: every hidden layer's activations,
taken by one launch of ``csrc/apoz.cu`` (``apoz_counts_leaves``), which
also writes the fractions when given the reciprocal; the single-matrix
``apoz_counts`` is a one-leaf table.  Each wrapper dispatches on the
tensors' device: CPU tensors go to the plain version leaf by leaf; CUDA
tensors launch the hand-written Hopper kernel or raise.  ``launches``
counts kernel launches only.  The reference takes its Pallas kernel only
when ``B % 512 == 0`` and ``N % 256 == 0`` and a ``jnp`` mean otherwise;
the port takes the kernel for every CUDA shape: count · fl(1/B), which
both of the reference's branches compute, is the same number either way.

The reference's jit-cache hooks (``apoz_scorer_compile_count`` and its
reset) count what the port compiles per shape: PyTorch runs the scorer
eagerly, so 0.
"""
from __future__ import annotations

from array import array
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.models.mlp_net import mlp_activations

MAX_LEAVES = 16          # leaves a launch takes: MAX_LEAVES in the source
MAX_COLS = 1 << 16       # columns a launch takes: MAX_COLS in the source

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def apoz_scorer_compile_count() -> int:
    """The reference's jit-cache size of its APoZ scorer: the port
    compiles none, 0."""
    return 0


def reset_apoz_scorer_compile_count() -> None:
    """The reference clears its scorer's jit cache; the port holds none."""


def apoz_counts_plain(acts: torch.Tensor) -> torch.Tensor:
    """(N,) int32 count of exact zeros per column of acts (B, N)."""
    return torch.count_nonzero(acts == 0, dim=0).to(torch.int32)


def apoz_leaves_plain(acts_list: Sequence[torch.Tensor],
                      recip: Optional[float] = None
                      ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Every leaf's counts, and with ``recip`` the fractions
    fl(count · recip) of all leaves in one fp32 vector, leaf after leaf."""
    counts = [apoz_counts_plain(a) for a in acts_list]
    if recip is None:
        return counts, None
    return counts, torch.cat(counts).to(torch.float32) * recip


def _check(acts: torch.Tensor) -> None:
    if acts.ndim != 2 or acts.shape[0] == 0 or acts.shape[1] == 0:
        raise ValueError(f"apoz_counts takes a non-empty (B, N) matrix, got "
                         f"shape {tuple(acts.shape)}")
    if acts.dtype != torch.float32:
        raise TypeError(f"apoz_counts takes fp32 activations, got "
                        f"{acts.dtype}")
    if not acts.is_contiguous():
        raise ValueError("apoz_counts takes a contiguous (row-major) matrix")
    if acts.shape[0] >= 2 ** 31:
        raise ValueError(f"apoz_counts takes fewer than 2^31 rows, got "
                         f"{acts.shape[0]}")


def apoz_counts_leaves(acts_list: Sequence[torch.Tensor],
                       recip: Optional[float] = None
                       ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """(every leaf's (N,) int32 zero counts, the fp32 fractions or None).

    ``-0.0`` counts as a zero and NaN does not (IEEE ``== 0``).  With
    ``recip`` the fractions fl(count · recip) of all leaves come in one
    fp32 vector, leaf after leaf (one rounding: with recip = fl(1/B) that
    is the reference's APoZ bitwise).  CUDA: one launch, exact (integer
    tickets), the outputs views of one allocation; at most ``MAX_COLS``
    columns in all.
    """
    global launches
    if not 0 < len(acts_list) <= MAX_LEAVES:
        raise ValueError(f"apoz_counts takes 1 to {MAX_LEAVES} leaves, got "
                         f"{len(acts_list)}")
    for a in acts_list:
        _check(a)
    device = acts_list[0].device
    if any(a.device != device for a in acts_list):
        raise ValueError("apoz_counts: every leaf must be on one device")
    if device.type == "cpu":
        return apoz_leaves_plain(acts_list, recip)
    if device.type != "cuda":
        raise ValueError(f"apoz_counts runs on cpu or cuda, not {device}")
    widths = [int(a.shape[1]) for a in acts_list]
    total = sum(widths)
    if total > MAX_COLS:
        raise ValueError(f"apoz_counts takes at most {MAX_COLS} columns a "
                         f"launch, got {total}")
    # the counts of every leaf, then the fractions
    size = total if recip is None else 2 * total
    buf = torch.empty(size, dtype=torch.int32, device=device)
    base = buf.data_ptr()
    frac_at = base + 4 * total
    words, at = [], 0
    for a, n in zip(acts_list, widths):
        words += [a.data_ptr(), int(a.shape[0]), n, base + 4 * at,
                  frac_at + 4 * at if recip is not None else 0]
        at += n
    table = array("q", words)
    lib = build.libraries()["apoz"]
    build.check(lib.apoz_counts_launch(
        table.buffer_info()[0], len(acts_list),
        0.0 if recip is None else float(recip),
        torch.cuda.current_stream(device).cuda_stream),
        "apoz_counts kernel launch")
    launches += 1
    counts = list(buf[:total].split(widths))
    if recip is None:
        return counts, None
    return counts, buf[total:].view(torch.float32)


def apoz_counts(acts: torch.Tensor) -> torch.Tensor:
    """(N,) int32 count of exact zeros per column of acts (B, N) fp32: a
    one-leaf table."""
    return apoz_counts_leaves([acts])[0][0]


def apoz_batch_fractions(params: Sequence[dict], xb: torch.Tensor,
                         neuron_masks: Optional[Sequence[torch.Tensor]]
                         = None) -> torch.Tensor:
    """The exact-zero fractions of every hidden neuron (fp32, (Σ H_l,),
    layer after layer) for one validation batch, in one launch on CUDA;
    bitwise the reference's scorer: count · fl(1/B) in fp32 — XLA
    compiles the reference's ``count / B`` and ``jnp.mean`` alike into a
    multiply by the fp32 reciprocal, which differs from a true division
    in the last bit for most B.  ``neuron_masks`` (mask-mode SCBFwP)
    zeroes pruned neurons, whose fraction is then B · fl(1/B) ≈ 1."""
    recip = float(np.float32(1.0) / np.float32(xb.shape[0]))
    with torch.no_grad():
        acts = mlp_activations(params, xb, neuron_masks)
        return apoz_counts_leaves([a.contiguous() for a in acts], recip)[1]
