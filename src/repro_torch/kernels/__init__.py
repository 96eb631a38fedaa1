"""Hopper kernels for SCBF's per-loop gradient pass (port of
``repro.kernels``): channel_norm (K1), select_mask (K2), select_compact
(K3) and apoz (K4), each a CUDA C++ source in ``csrc/`` with its plain
PyTorch version beside it.  ``sum_sgd``, the LM step's clients' sum and
SGD update in one pass, is the port's own: it replaces no TPU kernel
and has no name among the reference's ``ops``.

The reference's ``ops`` wrappers, mapped onto the kernel modules' public
functions and resolved on first use (``lazy_exports``); no import builds
or loads a library — each is built at its first launch.
``select_mask`` is the K2 module, callable as its one-leaf wrapper (the
module's name is the reference's function's); ``scbf_select_fused`` is
K2 returning its count (``select_fused``).
"""
from repro_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "channel_norms": ("repro_torch.kernels.channel_norm", "channel_norms"),
    "select_mask": ("repro_torch.kernels.select_mask", None),
    "scbf_select_fused": ("repro_torch.kernels.select_mask",
                          "select_fused"),
    "apoz_counts": ("repro_torch.kernels.apoz", "apoz_counts")})
