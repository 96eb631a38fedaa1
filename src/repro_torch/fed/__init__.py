"""Cross-device federation engine: batched client cohorts with
bucketed-P padding, round scheduling and pluggable aggregation (port of
``repro.fed``).

The reference's exports, resolved on first use (``lazy_exports``).  Its
jit-cache hooks (``scbf_compile_count`` and its reset) count what the
port compiles per shape, which is nothing (``fed.engine``).
"""
from repro_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    **{name: ("repro_torch.fed.cohort", name) for name in (
        "PaddedCohort", "bucket_size", "pad_clients")},
    **{name: ("repro_torch.fed.engine", name) for name in (
        "BatchedEngine", "SequentialEngine", "make_engine",
        "reset_scbf_compile_count", "scbf_compile_count", "stack_pytrees")},
    **{name: ("repro_torch.fed.scheduler", name) for name in (
        "FedBuffScheduler", "RoundPlan", "SyncScheduler",
        "make_scheduler")},
    **{name: ("repro_torch.fed.strategy", name) for name in (
        "FedAvg", "FedBuff", "RoundContribution", "ScbfSum", "ServerState",
        "make_strategy")}})
