"""The port's main path against the reference, end to end on the CPU:
``repro_torch.core.scbf.run_federated`` vs ``repro.core.scbf.run_federated``
on one small cohort, on the same engine (batched or sequential), fed the
reference's initial weights, epoch permutations and DP normals."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.config import FedConfig as RefFedConfig
from repro.config import ScbfConfig as RefScbfConfig
from repro.config import TrainConfig as RefTrainConfig
from repro.core.scbf import run_federated as ref_run
from repro.data.medical import dirichlet_split as ref_dirichlet
from repro.data.medical import federated_split as ref_split
from repro.data.medical import generate_cohort as ref_cohort
from repro_torch import config as tcfg
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.fed.scheduler import SyncScheduler

from _torch_parity import np_tree, reference_draws

FEATS = (64, 32, 16, 1)
CLIENTS, LOOPS, EPOCHS, BATCH, SEED = 3, 2, 1, 64, 0


# SCBFwP / FAwP: 48 hidden neurons, θ = 0.25 of the remaining per loop up
# to θ_total = 0.4 (19 neurons): 12 go at loop 0 and 7 at loop 1, so mask
# mode ships effective-geometry payloads at loop 1, compacts after it, and
# runs the compacted model at loop 2
PRUNE = dict(prune=True, prune_rate=0.25, prune_total=0.4)
PRUNED_LOOPS = 3


def _cfgs(method, loops=LOOPS, engine="sequential", **scbf):
    lr = 0.05 / CLIENTS if method == "scbf" else 0.05
    ref = RefTrainConfig(learning_rate=lr, global_loops=loops,
                         local_epochs=EPOCHS, local_batch_size=BATCH,
                         seed=SEED,
                         scbf=RefScbfConfig(num_clients=CLIENTS, **scbf),
                         fed=RefFedConfig(engine=engine))
    port = tcfg.TrainConfig(learning_rate=lr, global_loops=loops,
                            local_epochs=EPOCHS, local_batch_size=BATCH,
                            seed=SEED,
                            scbf=tcfg.ScbfConfig(num_clients=CLIENTS,
                                                 **scbf),
                            fed=tcfg.FedConfig(engine=engine))
    return ref, port


# DP: σ = 0.3 on every revealed coordinate (the reference's normals are
# injected, so the payloads are the reference's to fp32 rounding)
DP = dict(dp_noise_multiplier=0.3, dp_clip_norm=1.0)


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("method,loops,scbf", [
    ("scbf", LOOPS, {}),
    ("fedavg", LOOPS, {}),
    ("scbf", PRUNED_LOOPS, dict(PRUNE, prune_impl="reshape")),
    ("fedavg", PRUNED_LOOPS, dict(PRUNE, prune_impl="reshape")),
    ("scbf", PRUNED_LOOPS, dict(PRUNE, prune_impl="mask",
                                prune_compact=True)),
    ("scbf", LOOPS, DP),
], ids=["scbf", "fedavg", "scbfwp-reshape", "fedavgwp-reshape",
        "scbfwp-mask-compact", "scbf-dp"])
def test_run_federated_matches_reference(method, loops, scbf, engine):
    """Per loop the reference's bytes, upload fraction, participants,
    hidden sizes and ε exactly, AUC to 1e-3 and final weights to 1e-5 —
    each package on the same engine."""
    cohort = ref_cohort(num_admissions=1500, num_medicines=64, seed=SEED)
    shards = ref_split(cohort.x_train, cohort.y_train, CLIENTS, seed=SEED)
    init, perms, dp_noise = reference_draws(
        SEED, FEATS, [len(y) for _, y in shards], loops, EPOCHS)
    ref_cfg, port_cfg = _cfgs(method, loops, engine, **scbf)
    want = ref_run(cohort, ref_cfg, method=method, mlp_features=FEATS)
    got = run_federated(
        generate_cohort(num_admissions=1500, num_medicines=64, seed=SEED),
        port_cfg, method=method, mlp_features=FEATS, device="cpu",
        init_params=init, perms=perms, dp_noise=dp_noise)
    assert got.method == want.method
    assert got.dp_delta == want.dp_delta
    assert len(got.records) == len(want.records) == loops
    for g, w in zip(got.records, want.records):
        assert g.upload_fraction == w.upload_fraction
        assert g.sparse_bytes == w.sparse_bytes
        assert g.dense_bytes == w.dense_bytes
        assert g.num_participants == w.num_participants
        assert g.hidden_sizes == w.hidden_sizes
        assert g.flops_proxy == w.flops_proxy
        assert g.epsilon == w.epsilon
        assert g.epsilon_unamplified == w.epsilon_unamplified
        np.testing.assert_allclose(g.auc_roc, w.auc_roc, atol=1e-3)
        np.testing.assert_allclose(g.auc_pr, w.auc_pr, atol=1e-3)
    for lg, lw in zip(np_tree(got.final_params), np_tree(want.final_params)):
        for k in lw:
            assert lg[k].shape == lw[k].shape
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-5, rtol=0)
    if scbf.get("prune"):
        sizes = [r.hidden_sizes for r in got.records]
        assert sum(sizes[0]) == 48 - 12 and sum(sizes[-1]) == 48 - 19


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("scbf", [{}, DP], ids=["scbf", "scbf-dp"])
def test_dirichlet_sampled_run_matches_reference(engine, scbf):
    """Ragged Dirichlet shards under client sampling and dropout (2 of 3
    clients invited, some rounds empty): per loop the reference's
    participants, bytes, upload fraction and ε exactly, AUC to 1e-3 and
    final weights to 1e-5 — on each engine, the batched one permuting the
    padded shard n_max and training with the masked loss."""
    fed_kw = dict(partition="dirichlet", dirichlet_alpha=0.5,
                  sample_fraction=0.6, dropout_rate=0.3)
    loops = 4
    cohort = ref_cohort(num_admissions=1500, num_medicines=64, seed=SEED)
    shards = ref_dirichlet(cohort.x_train, cohort.y_train, CLIENTS,
                           alpha=0.5, seed=SEED)
    sizes = [len(y) for _, y in shards]
    if engine == "batched":
        sizes = [max(sizes)] * CLIENTS
    scheduler = SyncScheduler(CLIENTS, tcfg.FedConfig(**fed_kw), SEED)
    parts = [scheduler.plan(loop).participants for loop in range(loops)]
    init, perms, dp_noise = reference_draws(
        SEED, FEATS, sizes, loops, EPOCHS, participants=lambda l: parts[l])
    ref_cfg, port_cfg = _cfgs("scbf", loops, engine, **scbf)
    ref_cfg = dataclasses.replace(
        ref_cfg, fed=RefFedConfig(engine=engine, **fed_kw))
    port_cfg = dataclasses.replace(
        port_cfg, fed=tcfg.FedConfig(engine=engine, **fed_kw))
    want = ref_run(cohort, ref_cfg, method="scbf", mlp_features=FEATS)
    got = run_federated(
        generate_cohort(num_admissions=1500, num_medicines=64, seed=SEED),
        port_cfg, method="scbf", mlp_features=FEATS, device="cpu",
        init_params=init, perms=perms, dp_noise=dp_noise)
    assert [r.num_participants for r in got.records] == \
        [len(p) for p in parts] == [r.num_participants for r in want.records]
    assert 0 in [len(p) for p in parts]        # an empty round is skipped
    for g, w in zip(got.records, want.records):
        assert (g.sparse_bytes, g.dense_bytes, g.upload_fraction,
                g.epsilon) == (w.sparse_bytes, w.dense_bytes,
                               w.upload_fraction, w.epsilon)
        np.testing.assert_allclose(g.auc_roc, w.auc_roc, atol=1e-3)
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
    dict(fed=tcfg.FedConfig(pods=2)),
], ids=["pods"])
def test_out_of_slice_configs_refused(change):
    """Pods run as ranks of a process group (``tests/test_torch_pods.py``):
    without one, ``pods`` = 2 is refused in the reference's words."""
    cohort = generate_cohort(num_admissions=200, num_medicines=16, seed=0)
    cfg = tcfg.TrainConfig(global_loops=1, **change)
    with pytest.raises(RuntimeError, match="need 2 devices for a pod mesh"):
        run_federated(cohort, cfg, mlp_features=(16, 8, 4, 1), device="cpu")


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("change", [
    dict(debug_checks=True),
    dict(obs=dict(device_metrics=True)),
], ids=["debug_checks", "device_metrics"])
def test_observability_configs_run_as_the_reference(change, engine):
    """``debug_checks`` and ``ObsConfig.device_metrics`` (once refused)
    run as the reference runs them: per loop the reference's bytes and
    upload fractions, AUC to 1e-3, the train loss (collected by both with
    device metrics on, by neither without) to 1e-5, weights to 1e-5."""
    cohort = ref_cohort(num_admissions=1500, num_medicines=64, seed=SEED)
    shards = ref_split(cohort.x_train, cohort.y_train, CLIENTS, seed=SEED)
    init, perms, _ = reference_draws(
        SEED, FEATS, [len(y) for _, y in shards], LOOPS, EPOCHS)
    ref_cfg, port_cfg = _cfgs("scbf", LOOPS, engine)
    if "obs" in change:
        from repro.config import ObsConfig as RefObsConfig
        ref_cfg = dataclasses.replace(ref_cfg,
                                      obs=RefObsConfig(**change["obs"]))
        port_cfg = dataclasses.replace(port_cfg,
                                       obs=tcfg.ObsConfig(**change["obs"]))
    else:
        ref_cfg = dataclasses.replace(ref_cfg, **change)
        port_cfg = dataclasses.replace(port_cfg, **change)
    want = ref_run(cohort, ref_cfg, method="scbf", mlp_features=FEATS)
    got = run_federated(
        generate_cohort(num_admissions=1500, num_medicines=64, seed=SEED),
        port_cfg, method="scbf", mlp_features=FEATS, device="cpu",
        init_params=init, perms=perms)
    for g, w in zip(got.records, want.records):
        assert (g.sparse_bytes, g.upload_fraction) == \
            (w.sparse_bytes, w.upload_fraction)
        np.testing.assert_allclose(g.auc_roc, w.auc_roc, atol=1e-3)
        assert (g.train_loss is None) == (w.train_loss is None) == \
            ("obs" not in change)
        if w.train_loss is not None:
            np.testing.assert_allclose(g.train_loss, w.train_loss,
                                       atol=1e-5)
    for lg, lw in zip(np_tree(got.final_params), np_tree(want.final_params)):
        for k in lw:
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-5, rtol=0)


@pytest.mark.parametrize("fuse", [0, -2])
def test_fuse_rounds_below_one_raises_value_error(fuse):
    """Both packages refuse ``fuse_rounds < 1`` with the reference's
    ValueError, before anything runs."""
    with pytest.raises(ValueError, match="fuse_rounds must be >= 1"):
        ref_run(ref_cohort(num_admissions=200, num_medicines=16, seed=0),
                RefTrainConfig(global_loops=1,
                               fed=RefFedConfig(fuse_rounds=fuse)),
                mlp_features=(16, 8, 4, 1))
    with pytest.raises(ValueError, match="fuse_rounds must be >= 1"):
        run_federated(generate_cohort(num_admissions=200, num_medicines=16,
                                      seed=0),
                      tcfg.TrainConfig(global_loops=1,
                                       fed=tcfg.FedConfig(fuse_rounds=fuse)),
                      mlp_features=(16, 8, 4, 1), device="cpu")


def test_mask_pruning_with_fedavg_raises_in_both_packages():
    """Mask-mode keep-masks ride the sparse scbf pipeline; FAwP prunes by
    reshaping — both packages refuse the combination up front."""
    ref_cfg, port_cfg = _cfgs("fedavg", 1, prune=True, prune_impl="mask")
    with pytest.raises(ValueError, match="reshape"):
        ref_run(ref_cohort(num_admissions=200, num_medicines=16, seed=0),
                ref_cfg, method="fedavg", mlp_features=(16, 8, 4, 1))
    with pytest.raises(ValueError, match="reshape"):
        run_federated(generate_cohort(num_admissions=200, num_medicines=16,
                                      seed=0),
                      port_cfg, method="fedavg", mlp_features=(16, 8, 4, 1),
                      device="cpu")


def test_unknown_prune_impl_raises():
    cohort = generate_cohort(num_admissions=200, num_medicines=16, seed=0)
    cfg = tcfg.TrainConfig(global_loops=1, scbf=tcfg.ScbfConfig(
        prune=True, prune_impl="drop"))
    with pytest.raises(ValueError, match="prune_impl"):
        run_federated(cohort, cfg, mlp_features=(16, 8, 4, 1), device="cpu")


def test_fed_config_defaults_match_reference_except_engine():
    """The port's config defaults are the reference's, the engine
    (``batched``) included."""
    ref, port = RefFedConfig(), tcfg.FedConfig()
    for f in ("engine", "sample_fraction", "dropout_rate", "straggler_rate",
              "mode", "partition", "dirichlet_alpha", "fuse_rounds",
              "bucket", "pods", "max_update_norm", "min_valid_participants"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.engine == "batched"
    assert tcfg.ScbfConfig().__dict__ == RefScbfConfig().__dict__
