"""The port's main path against the reference, end to end on the CPU:
``repro_torch.core.scbf.run_federated`` vs ``repro.core.scbf.run_federated``
on one small cohort, fed the reference's initial weights and epoch
permutations."""
import numpy as np
import pytest
import torch

from repro.config import FedConfig as RefFedConfig
from repro.config import ScbfConfig as RefScbfConfig
from repro.config import TrainConfig as RefTrainConfig
from repro.core.scbf import run_federated as ref_run
from repro.data.medical import federated_split as ref_split
from repro.data.medical import generate_cohort as ref_cohort
from repro_torch import config as tcfg
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort

from _torch_parity import np_tree, reference_draws

FEATS = (64, 32, 16, 1)
CLIENTS, LOOPS, EPOCHS, BATCH, SEED = 3, 2, 1, 64, 0


def _cfgs(method):
    lr = 0.05 / CLIENTS if method == "scbf" else 0.05
    ref = RefTrainConfig(learning_rate=lr, global_loops=LOOPS,
                         local_epochs=EPOCHS, local_batch_size=BATCH,
                         seed=SEED, scbf=RefScbfConfig(num_clients=CLIENTS),
                         fed=RefFedConfig(engine="sequential"))
    port = tcfg.TrainConfig(learning_rate=lr, global_loops=LOOPS,
                            local_epochs=EPOCHS, local_batch_size=BATCH,
                            seed=SEED,
                            scbf=tcfg.ScbfConfig(num_clients=CLIENTS))
    return ref, port


@pytest.mark.parametrize("method", ["scbf", "fedavg"])
def test_run_federated_matches_reference(method):
    cohort = ref_cohort(num_admissions=1500, num_medicines=64, seed=SEED)
    shards = ref_split(cohort.x_train, cohort.y_train, CLIENTS, seed=SEED)
    init, perms = reference_draws(SEED, FEATS, [len(y) for _, y in shards],
                                  LOOPS, EPOCHS)
    ref_cfg, port_cfg = _cfgs(method)
    want = ref_run(cohort, ref_cfg, method=method, mlp_features=FEATS)
    got = run_federated(
        generate_cohort(num_admissions=1500, num_medicines=64, seed=SEED),
        port_cfg, method=method, mlp_features=FEATS, device="cpu",
        init_params=init, perms=perms)
    assert len(got.records) == len(want.records) == LOOPS
    for g, w in zip(got.records, want.records):
        assert g.upload_fraction == w.upload_fraction
        assert g.sparse_bytes == w.sparse_bytes
        assert g.dense_bytes == w.dense_bytes
        assert g.num_participants == w.num_participants
        assert g.hidden_sizes == w.hidden_sizes
        assert g.flops_proxy == w.flops_proxy
        np.testing.assert_allclose(g.auc_roc, w.auc_roc, atol=1e-3)
        np.testing.assert_allclose(g.auc_pr, w.auc_pr, atol=1e-3)
    for lg, lw in zip(np_tree(got.final_params), np_tree(want.final_params)):
        for k in lw:
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-5, rtol=0)


def test_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    cohort = generate_cohort(num_admissions=200, num_medicines=16, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated(cohort, tcfg.TrainConfig(global_loops=1),
                      mlp_features=(16, 8, 4, 1))


@pytest.mark.parametrize("change", [
    dict(scbf=tcfg.ScbfConfig(prune=True)),
    dict(scbf=tcfg.ScbfConfig(dp_noise_multiplier=1.0)),
    dict(fed=tcfg.FedConfig(engine="batched")),
    dict(fed=tcfg.FedConfig(fuse_rounds=4)),
    dict(fed=tcfg.FedConfig(mode="fedbuff")),
    dict(fed=tcfg.FedConfig(clock=tcfg.ClockConfig(enabled=True))),
    dict(fed=tcfg.FedConfig(faults=tcfg.FaultConfig(enabled=True))),
    dict(fed=tcfg.FedConfig(max_update_norm=1.0)),
    dict(fed=tcfg.FedConfig(min_valid_participants=2)),
], ids=["prune", "dp", "batched", "fused", "fedbuff", "clock", "faults",
        "admission", "quorum"])
def test_out_of_slice_configs_refused(change):
    cohort = generate_cohort(num_admissions=200, num_medicines=16, seed=0)
    cfg = tcfg.TrainConfig(global_loops=1, **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_federated(cohort, cfg, mlp_features=(16, 8, 4, 1), device="cpu")


def test_fed_config_defaults_match_reference_except_engine():
    ref, port = RefFedConfig(), tcfg.FedConfig()
    for f in ("sample_fraction", "dropout_rate", "straggler_rate", "mode",
              "partition", "dirichlet_alpha", "fuse_rounds", "bucket",
              "pods", "max_update_norm", "min_valid_participants"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.engine == "sequential" and ref.engine == "batched"
    assert tcfg.ScbfConfig().__dict__ == RefScbfConfig().__dict__
