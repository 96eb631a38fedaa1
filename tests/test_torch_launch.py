"""The port's launcher (``repro_torch.launch.train``): what each
``--methods`` entry runs, against the reference launcher's rules."""
import pytest

from repro_torch.launch.train import fed_config, method_config, parse_args


def test_default_methods_are_the_references():
    assert parse_args([]).methods == "scbf,fedavg,scbfwp,fedavgwp"


@pytest.mark.parametrize("method,base,lr,prune", [
    ("scbf", "scbf", 0.01, False),
    ("fedavg", "fedavg", 0.05, False),
    ("scbfwp", "scbf", 0.01, True),         # SCBF's 1/K lr, pruned
    ("fedavgwp", "fedavg", 0.05, True),
])
def test_method_config(method, base, lr, prune):
    args = parse_args(["--prune-rate", "0.2", "--prune-total", "0.3",
                       "--prune-impl", "mask"])
    got_base, cfg = method_config(method, args)
    assert got_base == base
    assert cfg.learning_rate == pytest.approx(lr)
    assert cfg.scbf.prune is prune
    assert (cfg.scbf.prune_rate, cfg.scbf.prune_total,
            cfg.scbf.prune_impl) == (0.2, 0.3, "mask")


def test_engine_and_dp_noise_reach_the_config():
    """``--engine`` (default ``batched``, as the reference's CLI) and
    ``--dp-noise`` (the scbf uploads' noise multiplier) reach the run's
    config."""
    args = parse_args([])
    assert args.engine == "batched" and args.dp_noise == 0.0
    assert fed_config(args).engine == "batched"
    args = parse_args(["--engine", "sequential", "--dp-noise", "1.5"])
    _, cfg = method_config("scbf", args, fed_config(args))
    assert cfg.fed.engine == "sequential"
    assert cfg.scbf.dp_noise_multiplier == 1.5
    with pytest.raises(SystemExit):
        parse_args(["--engine", "fused"])
