"""Sharding rules of the pod, data and model mesh axes (port of
``repro.sharding``).

The reference's exports, resolved on first use (``lazy_exports``).
"""
from repro_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    name: ("repro_torch.sharding.rules", name) for name in (
        "ShardingRules", "param_shardings", "activation_spec",
        "batch_spec")})
