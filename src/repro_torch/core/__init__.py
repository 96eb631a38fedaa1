"""The paper's contribution: Stochastic Channel-Based Federated Learning
(port of ``repro.core``).

The reference's exports, resolved on first use (``lazy_exports``).
"""
from repro_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "LoopRecord": ("repro_torch.core.scbf", "LoopRecord"),
    "RunResult": ("repro_torch.core.scbf", "RunResult"),
    "run_federated": ("repro_torch.core.scbf", "run_federated"),
    "run_fedavg": ("repro_torch.core.fedavg", "run_fedavg"),
    "fedavg_update": ("repro_torch.core.server", "fedavg_update"),
    "scbf_update": ("repro_torch.core.server", "scbf_update"),
    "client_delta": ("repro_torch.core.client", "client_delta"),
    "local_train": ("repro_torch.core.client", "local_train_impl"),
    "channels": ("repro_torch.core.channels", None),
    "privacy": ("repro_torch.core.privacy", None),
    "pruning": ("repro_torch.core.pruning", None),
    "selection": ("repro_torch.core.selection", None),
})
