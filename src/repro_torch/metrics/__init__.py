"""AUC-ROC, AUC-PR and the BCE loss (port of ``repro.metrics``), resolved
on first use (``lazy_exports``)."""
from repro_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    name: ("repro_torch.metrics.auc", name) for name in (
        "auc_roc", "auc_pr", "binary_cross_entropy")})
