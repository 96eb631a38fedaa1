"""``TrainConfig.debug_checks`` of the port (``repro_torch.obs.checks``)
against the reference's (``repro.obs.checks``), the counterparts of
``tests/test_debug_checks.py``: the same verdicts and the same messages on
the same trees, and checked runs bitwise their unchecked runs, per round
and fused, on both engines."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import checks as ref_checks
from repro_torch import config as tcfg
from repro_torch.core.scbf import run_federated
from repro_torch.data.medical import generate_cohort
from repro_torch.fed import engine
from repro_torch.fed.cohort import bucket_size
from repro_torch.obs import checks
from repro_torch.params import from_numpy

FEATS = (24, 8, 4, 1)


@pytest.fixture(scope="module")
def cohort():
    return generate_cohort(num_admissions=600, num_medicines=24, seed=0)


def _tcfg(**kw):
    kw = dict(dict(learning_rate=0.05, global_loops=2, local_batch_size=32,
                   local_epochs=1,
                   scbf=tcfg.ScbfConfig(upload_rate=0.25, num_clients=3)),
              **kw)
    return tcfg.TrainConfig(**kw)


def _message(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except AssertionError as e:
        assert type(e).__name__ == "DebugCheckError"
        return str(e)
    return None


# ---------------------------------------------------------------------------
# unit contracts, message for message
# ---------------------------------------------------------------------------

def _trees(case):
    """(port tree, reference tree) of the same values."""
    if case == "good":
        w, b = np.ones((3, 2), np.float32), np.zeros(2, np.float32)
    elif case == "nan":
        w, b = np.ones((3, 2), np.float32), np.zeros(2, np.float32)
        w[1, 0] = np.nan
    elif case == "inf-bias":
        w, b = np.ones((3, 2), np.float32), np.full(2, -np.inf, np.float32)
    else:
        w = np.ones((3, 2), np.float32)
        b = np.array([np.nan, np.inf], np.float32)
    port = ({"w": torch.ones(2, 2), "b": torch.zeros(2)},
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    ref = ({"w": jnp.ones((2, 2)), "b": jnp.zeros(2)},
           {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    return port, ref


@pytest.mark.parametrize("case", ["good", "nan", "inf-bias", "mixed"])
def test_check_finite_names_the_bad_leaf_as_the_reference(case):
    port, ref = _trees(case)
    got = _message(checks.check_finite, port, where="loop 3")
    want = _message(ref_checks.check_finite, ref, where="loop 3")
    assert got == want
    if case == "nan":
        assert "loop 3" in got and "'1/w'" in got and "1 nan / 0 inf" in got


def test_check_finite_exempts_integers_and_none():
    checks.check_finite((torch.arange(4),), where="unit")
    checks.check_finite(None, where="unit")
    checks.check_finite({"participants": 3, "selected": [1, 2],
                         "train_loss": 0.5}, where="unit")
    inf = ({"w": torch.full((2,), float("inf"))},)
    with pytest.raises(checks.DebugCheckError, match="2 inf"):
        checks.check_finite(inf, where="unit")


def test_metrics_dicts_are_checked_as_the_reference():
    dm = {"participants": 3, "train_loss": float("nan"),
          "codec_bytes": {"coo": 1, "bitmap": 0, "dense": 0}}
    assert _message(checks.verify_round, None, dm, where="chunk@loop 0") \
        == _message(ref_checks.verify_round, None, dm,
                    where="chunk@loop 0")


@pytest.mark.parametrize("count,p_count,where", [
    (3, 3, "unit"), (None, 3, "unit"), (3, None, "unit"),
    (4, 3, "chunk@loop 0")])
def test_check_participants_detects_mask_skew(count, p_count, where):
    got = _message(checks.check_participants,
                   None if count is None else torch.tensor(count), p_count,
                   where=where)
    want = _message(ref_checks.check_participants,
                    None if count is None else jnp.asarray(count), p_count,
                    where=where)
    assert got == want
    assert (got is None) == (count is None or p_count is None
                             or count == p_count)
    if got is not None:
        assert "skew" in got


def test_verify_records_rejects_nonfinite_fields():
    @dataclasses.dataclass
    class Rec:
        loss: float
        auc_roc: float

    checks.verify_records([Rec(0.5, 0.9)], where="unit")
    bad = [Rec(0.5, 0.9), Rec(0.5, float("nan"))]
    got = _message(checks.verify_records, bad, where="unit")
    assert got == _message(ref_checks.verify_records, bad, where="unit")
    assert "auc_roc" in got and "record 1" in got


def test_verify_round_on_a_poisoned_model():
    """One NaN in layer 0's weight: the error names ``0/w`` with ``1 nan /
    0 inf`` at the boundary's ``[params]``."""
    params = from_numpy(({"w": np.ones((4, 3)), "b": np.zeros(3)},
                         {"w": np.ones((3, 1)), "b": np.zeros(1)}), "cpu")
    checks.verify_round(params, {"train_loss": 0.3}, where="loop 0")
    params[0]["w"][2, 1] = float("nan")
    with pytest.raises(checks.DebugCheckError) as exc:
        checks.verify_round(params, None, where="loop 1")
    msg = str(exc.value)
    assert "loop 1 [params]" in msg and "'0/w'" in msg and \
        "1 nan / 0 inf of 12 elements" in msg


# ---------------------------------------------------------------------------
# the parity contract: debug_checks does not perturb a run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine_name,fuse,method", [
    ("batched", 1, "scbf"), ("sequential", 1, "scbf"),
    ("batched", 2, "scbf"), ("batched", 2, "fedavg"),
    ("sequential", 1, "fedavg")])
def test_debug_checks_bitwise_parity(cohort, engine_name, fuse, method):
    fed = tcfg.FedConfig(fuse_rounds=fuse, engine=engine_name)
    base = run_federated(cohort, _tcfg(fed=fed, global_loops=4),
                         method=method, mlp_features=FEATS, device="cpu")
    checked = run_federated(cohort, _tcfg(fed=fed, global_loops=4,
                                          debug_checks=True),
                            method=method, mlp_features=FEATS, device="cpu")
    assert len(base.records) == len(checked.records) == 4
    for a, b in zip(base.records, checked.records):
        assert (a.auc_roc, a.auc_pr, a.sparse_bytes) == \
            (b.auc_roc, b.auc_pr, b.sparse_bytes)
    assert all(torch.equal(x[k], y[k]) for x, y in
               zip(base.final_params, checked.final_params) for k in x)


def test_debug_checks_fail_a_poisoned_run(cohort, monkeypatch):
    """A nonfinite server model fails a fused run at its first chunk
    boundary, named by its leaf."""
    from repro_torch.fed import strategy

    real = strategy.scbf_sum_step

    def poisoned(params, deltas, neuron_masks=None):
        out = real(params, deltas, neuron_masks=neuron_masks)
        return (dict(out[0], w=out[0]["w"] * float("nan")),) + out[1:]

    monkeypatch.setattr(engine, "scbf_sum_step", poisoned)
    with pytest.raises(checks.DebugCheckError,
                       match=r"chunk@loop 0 \[params\].*'0/w'"):
        run_federated(cohort, _tcfg(fed=tcfg.FedConfig(fuse_rounds=2),
                                    debug_checks=True),
                      mlp_features=FEATS, device="cpu")


# ---------------------------------------------------------------------------
# the unified loss accounting: masked sum == the sliced sum, bitwise
# ---------------------------------------------------------------------------

def test_fedavg_masked_loss_sum_bit_matches_sliced(monkeypatch):
    """``fedavg_round``'s loss is ``Σ where(valid, losses, 0)``; on a padded
    bucket (P = 3 → 4 slots) it is bitwise the sum of the real slots'
    losses over 3, as the reference's."""
    rng = np.random.default_rng(0)
    clients = [(rng.random((24, 12)).astype(np.float32),
                (rng.random(24) < 0.5).astype(np.float32))
               for _ in range(5)]
    eng = engine.BatchedEngine(clients, 8, 1, "cpu")
    params = from_numpy(({"w": rng.standard_normal((12, 8)) * 0.3,
                          "b": np.zeros(8)},
                         {"w": rng.standard_normal((8, 1)) * 0.3,
                          "b": np.zeros(1)}), "cpu")
    part = np.array([0, 2, 4])
    assert bucket_size(3, 5) == 4
    perms = [[rng.permutation(24)] for _ in part]
    captured = {}
    orig = engine._train_slots

    def spy(*args, **kw):
        out = orig(*args, **kw)
        captured["losses"] = out[1][1]
        return out

    monkeypatch.setattr(engine, "_train_slots", spy)
    _, _, dm = eng.fedavg_round(params, part, 0.1, perms, collect=True)
    losses = captured["losses"]
    assert tuple(losses.shape) == (4,)
    sliced = float(torch.sum(losses[:3]).to(torch.float32))
    assert dm["train_loss"] == sliced / 3
    assert float(losses[3]) == 0.0           # a padded slot takes no step
