"""Federated Averaging baseline (McMahan et al. 2016), the paper's
comparator (port of ``repro.core.fedavg``): a thin wrapper over the
shared driver, so both methods run the same local training, evaluation
and pruning."""
from __future__ import annotations

from repro_torch.config import TrainConfig
from repro_torch.core.scbf import RunResult, run_federated
from repro_torch.data.medical import MedicalCohort


def run_fedavg(cohort: MedicalCohort, train_cfg: TrainConfig,
               verbose: bool = False, **kw) -> RunResult:
    return run_federated(cohort, train_cfg, method="fedavg",
                         verbose=verbose, **kw)
