"""BAD (TL001): a kernel library loaded inside the launch wrapper, so
every prune step re-opens the shared object and re-declares its
launcher — the counterpart of a scorer rebuilt per pruning step.  The
fix is ``kernels/build.libraries``: one load a process, lru_cached."""
import ctypes

import torch


def apoz_counts(acts: torch.Tensor, path: str) -> torch.Tensor:
    lib = ctypes.CDLL(path)                 # loaded per call
    counts = torch.zeros(acts.shape[1], dtype=torch.int32,
                         device=acts.device)
    lib.apoz_counts_launch(ctypes.c_void_p(acts.data_ptr()),
                           acts.shape[0], acts.shape[1],
                           ctypes.c_void_p(counts.data_ptr()))
    return counts
