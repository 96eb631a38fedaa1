"""The synthetic medical cohort and token streams (port of
``repro.data``), resolved on first use (``lazy_exports``)."""
from repro_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    **{name: ("repro_torch.data.medical", name) for name in (
        "MedicalCohort", "generate_cohort", "federated_split",
        "dirichlet_split", "batch_iterator")},
    **{name: ("repro_torch.data.tokens", name) for name in (
        "synthetic_lm_batch", "SyntheticTokenStream")}})
