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

``launch_counts()`` and ``reset_launches()`` read and clear every
kernel's launch counters, by kernel: the port's one list of them.
"""
from repro_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "channel_norms": ("repro_torch.kernels.channel_norm", "channel_norms"),
    "select_mask": ("repro_torch.kernels.select_mask", None),
    "scbf_select_fused": ("repro_torch.kernels.select_mask",
                          "select_fused"),
    "apoz_counts": ("repro_torch.kernels.apoz", "apoz_counts")})


def launch_counts() -> dict:
    """Every kernel's wrapper launches since its last reset (a graph's
    replays are not among them), by kernel."""
    from repro_torch.kernels import apoz, channel_norm, select_mask, sum_sgd
    return {"channel_norm": channel_norm.launches,
            "select_mask": select_mask.mask_launches,
            "select_compact_count": select_mask.compact_count_launches,
            "select_compact_scatter": select_mask.compact_scatter_launches,
            "apoz": apoz.launches, "sum_sgd": sum_sgd.launches}


def reset_launches() -> None:
    """Set every kernel's launch counters to 0."""
    from repro_torch.kernels import apoz, channel_norm, select_mask, sum_sgd
    for mod in (channel_norm, select_mask, apoz, sum_sgd):
        mod.reset_launches()
