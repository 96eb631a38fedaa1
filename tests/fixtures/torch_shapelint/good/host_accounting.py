"""GOOD: deliberate float64 on the HOST side — privacy accounting and
wall-clock bookkeeping live outside any captured program, where f64 is
the right call (RDP epsilons lose precision in f32).  SL003 is scoped
to capture-reachable code, so this file has zero findings."""
import numpy as np
import torch


def epsilon_ledger(sigmas, q):
    # f64 accumulation on host: exempt from SL003 (not captured)
    total = np.float64(0.0)
    for s in sigmas:
        total += np.float64(q) / np.float64(s) ** 2
    return float(total)


def wall_clock_stats(durations):
    arr = torch.as_tensor(durations, dtype=torch.float64)
    return float(arr.mean()), float(arr.max())
