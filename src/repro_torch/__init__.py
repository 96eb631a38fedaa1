"""PyTorch/CUDA port of the SCBF reproduction (the JAX package ``repro``
is the reference it is checked against).

The layout mirrors ``repro`` module for module.  Entry points run on the
CUDA device unless the caller asks for the CPU (``repro_torch.device``);
the score-and-mask pass of Algorithm 1 runs through the hand-written
Hopper kernels in ``repro_torch.kernels``.
"""
import importlib


def lazy_exports(package: str, exports: dict):
    """``(__all__, __getattr__)`` for a package that re-exports
    ``exports[name] = (module, attr)`` (``attr`` None: the module itself),
    each resolved on first use: the port's packages import one another
    (``core.scbf`` the engines, the engines ``core`` and ``comm``), so an
    eager re-export would be circular whichever module is imported first,
    and importing ``repro_torch.kernels`` builds nothing."""

    def __getattr__(name):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute "
                                 f"{name!r}")
        module, attr = exports[name]
        mod = importlib.import_module(module)
        return mod if attr is None else getattr(mod, attr)

    return sorted(exports), __getattr__
