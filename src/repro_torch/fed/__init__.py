"""Cross-device federation engine: batched client cohorts with
bucketed-P padding, round scheduling and pluggable aggregation (port of
``repro.fed``).

The reference's exports, resolved on first use (``lazy_exports``), but
its jit-cache hooks (``scbf_compile_count`` and its reset), which have no
counterpart (ROADMAP A15).
"""
from repro_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    **{name: ("repro_torch.fed.cohort", name) for name in (
        "PaddedCohort", "bucket_size", "pad_clients")},
    **{name: ("repro_torch.fed.engine", name) for name in (
        "BatchedEngine", "SequentialEngine", "make_engine",
        "stack_pytrees")},
    **{name: ("repro_torch.fed.scheduler", name) for name in (
        "FedBuffScheduler", "RoundPlan", "SyncScheduler",
        "make_scheduler")},
    **{name: ("repro_torch.fed.strategy", name) for name in (
        "FedAvg", "FedBuff", "RoundContribution", "ScbfSum", "ServerState",
        "make_strategy")}})
