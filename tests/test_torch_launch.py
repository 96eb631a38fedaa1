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


def test_chaos_flags_reach_the_config():
    """The reference's chaos flags: ``--fault-trace`` arms injection (its
    seed defaults to ``--seed``), ``--deadline-quantile`` the clock with
    ``--deadline-action``, and the quorum and norm-gate flags reach
    ``FedConfig``; ``--events`` asks for the event logs."""
    args = parse_args([])
    fed = fed_config(args)
    assert not fed.faults.enabled and not fed.clock.enabled
    assert (fed.min_valid_participants, fed.max_update_norm,
            fed.norm_action) == (0, 0.0, "reject")
    assert args.events is False
    args = parse_args(["--fault-trace", "crash=0.1,bitflip=0.05",
                       "--seed", "3", "--deadline-quantile", "0.8",
                       "--deadline-action", "spill",
                       "--min-valid-participants", "3",
                       "--max-update-norm", "50", "--norm-action", "clip",
                       "--events"])
    fed = fed_config(args)
    assert fed.faults.enabled and fed.faults.seed == 3
    assert (fed.faults.crash_rate, fed.faults.bitflip_rate) == (0.1, 0.05)
    assert fed.clock.enabled and fed.clock.deadline_quantile == 0.8
    assert fed.clock.deadline_action == "spill"
    assert (fed.min_valid_participants, fed.max_update_norm,
            fed.norm_action) == (3, 50.0, "clip")
    assert args.events is True
    assert fed_config(parse_args(["--fault-trace", "seed=9,nan=0.2"])
                      ).faults.seed == 9
    with pytest.raises(SystemExit):
        parse_args(["--norm-action", "halve"])
    with pytest.raises(SystemExit):
        parse_args(["--deadline-action", "wait"])


def test_events_flag_writes_a_log_per_method(tmp_path, monkeypatch):
    """``--events`` on a tiny CPU run (a small cohort in place of the
    paper's) writes ``<out>/<method>.events.jsonl``, which the reference's
    report reader loads, with the fault trace's rejections in it."""
    from repro.obs import report

    import repro_torch.data.medical as medical
    from repro_torch.launch import train

    real = medical.generate_cohort
    monkeypatch.setattr(medical, "generate_cohort", lambda seed=0: real(
        num_admissions=600, num_medicines=24, seed=seed))
    args = parse_args(["--methods", "scbf", "--loops", "1", "--clients",
                       "2", "--device", "cpu", "--events", "--out",
                       str(tmp_path), "--local-epochs", "1",
                       "--fault-trace", "duplicate=1.0"])
    train.run_medical(args)
    events = report.read_events(str(tmp_path / "scbf.events.jsonl"))
    kinds = [e["ev"] for e in events]
    assert kinds[0] == "meta" and kinds[-1] == "run_end"
    assert kinds.count("payload_rejected") == 2


def test_full_scale_example_passes_its_flags(monkeypatch):
    """``examples/torch_federated_medical.py``: its flags (the reference
    example's and ``--device``) reach ``run_medical`` (monkeypatched) with
    the paper's local training, and the launcher builds its configs."""
    import importlib.util
    from pathlib import Path

    from repro_torch.launch import train

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_federated_medical.py"
    spec = importlib.util.spec_from_file_location("torch_fed_med", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    seen = []
    monkeypatch.setattr(train, "run_medical", seen.append)
    example.main(["--loops", "3", "--methods", "scbf,fedavgwp", "--lr",
                  "0.1", "--clients", "4", "--engine", "sequential",
                  "--sample-fraction", "0.5", "--dropout-rate", "0.1",
                  "--partition", "dirichlet", "--dirichlet-alpha", "0.3",
                  "--dp-noise", "0.7", "--seed", "2", "--out", "x",
                  "--device", "cpu"])
    args, = seen
    assert (args.loops, args.methods, args.lr, args.clients, args.engine,
            args.sample_fraction, args.dropout_rate, args.partition,
            args.dirichlet_alpha, args.dp_noise, args.seed, args.out,
            args.device) == (3, "scbf,fedavgwp", 0.1, 4, "sequential", 0.5,
                             0.1, "dirichlet", 0.3, 0.7, 2, "x", "cpu")
    assert (args.local_epochs, args.batch_size, args.upload_rate,
            args.prune_rate, args.prune_total) == (2, 256, 0.10, 0.10, 0.47)
    base, cfg = train.method_config("fedavgwp", args, train.fed_config(args))
    assert base == "fedavg" and cfg.scbf.prune and cfg.global_loops == 3
    assert cfg.fed.partition == "dirichlet" and cfg.fed.engine == \
        "sequential"
    defaults = example.launcher_args(example.parse_args([]))
    assert defaults.device is None and defaults.loops == 30 and \
        defaults.methods == "scbf,fedavg,scbfwp,fedavgwp"


STEP_LINE = r"step +\d+ loss \d+\.\d{4} \(\d+\.\ds\)"


def _reference_lines(monkeypatch, capsys, module, argv):
    """The reference launcher's printed lines for ``argv`` (JAX on the
    CPU, the smoke variant)."""
    import importlib
    import sys

    ref = importlib.import_module(module)
    monkeypatch.setattr(sys, "argv", [module] + argv)
    capsys.readouterr()
    ref.main()
    return capsys.readouterr().out.splitlines()


def test_lm_mode_runs_and_prints_the_references_lines(monkeypatch, capsys):
    """``--mode lm --device cpu --steps 2``: the reference's defaults (5
    clients, batch 4 when ``--batch-size`` is left at 256, seq 64, rate
    0.10, lr 0.05) and its ``step … loss … (…s)`` lines, a finite loss
    near the reference's on the smoke qwen2-0.5b (random init, vocab
    512: ln 512 ≈ 6.24)."""
    import re

    from repro_torch.launch import train

    want = _reference_lines(monkeypatch, capsys, "repro.launch.train",
                            ["--mode", "lm", "--steps", "2"])
    seen = []
    real = train.run_lm
    monkeypatch.setattr(train, "run_lm",
                        lambda args: seen.append(args) or real(args))
    params = train.main(["--mode", "lm", "--device", "cpu", "--steps", "2"])
    got = capsys.readouterr().out.splitlines()
    args, = seen
    assert (args.clients, args.batch_size, args.seq_len, args.upload_rate,
            args.lr, args.arch) == (5, 4, 64, 0.10, 0.05, "qwen2-0.5b")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert re.fullmatch(STEP_LINE, g) and re.fullmatch(STEP_LINE, w)
        assert g.split()[1] == w.split()[1]
        assert abs(float(g.split()[3]) - float(w.split()[3])) < 0.5
    assert params["embed"]["w"].device.type == "cpu"


def test_lm_mode_needs_cuda_unless_cpu_is_asked():
    import torch

    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--mode", "lm", "--steps", "1"])


def test_serve_runs_and_prints_the_references_lines(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --device cpu``: the reference's
    flags and four lines (arch and shapes, prefill, decode, the first 16
    sampled ids), ids in [0, V)."""
    import re

    from repro_torch.launch import serve

    argv = ["--gen", "6", "--batch", "2", "--prompt-len", "8"]
    want = _reference_lines(monkeypatch, capsys, "repro.launch.serve", argv)
    res = serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    assert got[0] == want[0] == "arch=qwen2-0.5b batch=2 prompt=8 gen=6"
    for g, w, pattern in zip(got[1:3], want[1:3], (
            r"prefill: \d+\.\d ms \(\d+ tok/s", r"decode:  \d+\.\d ms "
                                                r"\(\d+ tok/s\)")):
        assert re.match(pattern, g) and re.match(pattern, w)
    assert got[3].startswith("sample token ids[0]: [") and \
        want[3].startswith("sample token ids[0]: [")
    assert res.tokens.shape == (2, 6) and len(res.logits) == 6
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < 512
    assert torch_equal_greedy(res)


def torch_equal_greedy(res) -> bool:
    """Every id the greedy loop took is the argmax of its logits."""
    import torch
    return all(torch.equal(torch.argmax(lg, -1).to(torch.int32),
                           res.tokens[:, i])
               for i, lg in enumerate(res.logits))


def test_serve_examples_pass_their_flags(monkeypatch):
    """``examples/torch_serve_batched.py`` runs ``repro_torch.launch.serve``
    once an arch with its flags (the subprocess monkeypatched)."""
    import importlib.util
    import subprocess
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_serve_batched.py"
    spec = importlib.util.spec_from_file_location("torch_serve", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, check: calls.append(cmd))
    monkeypatch.setattr(sys, "argv", ["x", "--archs",
                                      "qwen2-0.5b,chatglm3-6b", "--gen",
                                      "3", "--device", "cpu"])
    example.main()
    assert [c[c.index("--arch") + 1] for c in calls] == \
        ["qwen2-0.5b", "chatglm3-6b"]
    assert all(c[2] == "repro_torch.launch.serve" and
               c[-2:] == ["--device", "cpu"] and
               c[c.index("--gen") + 1] == "3" for c in calls)


MOE_ARCHS = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_runs_the_moe_archs(monkeypatch, capsys, arch):
    """``--arch deepseek-v2-236b`` (MLA's latent cache, MoE) and
    ``--arch llama4-maverick-400b-a17b`` serve with no refusal: the
    reference's four lines, ids in [0, V), greedy ids the argmax of their
    logits."""
    import re

    from repro_torch.launch import serve

    argv = ["--arch", arch, "--gen", "4", "--batch", "2",
            "--prompt-len", "8"]
    want = _reference_lines(monkeypatch, capsys, "repro.launch.serve", argv)
    res = serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    assert got[0] == want[0] == f"arch={arch} batch=2 prompt=8 gen=4"
    assert re.match(r"decode:  \d+\.\d ms \(\d+ tok/s\)", got[2])
    assert res.tokens.shape == (2, 4) and len(res.logits) == 4
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < 512
    assert torch_equal_greedy(res)


def test_lm_mode_trains_deepseek_v2(monkeypatch, capsys):
    """``--mode lm --arch deepseek-v2-236b`` takes SCBF's federated step
    (the smoke variant's bf16 leaves and fp32 router) with no refusal:
    the reference's ``step … loss …`` lines, a loss near the
    reference's."""
    import re

    import torch

    from repro_torch.launch import train

    argv = ["--mode", "lm", "--arch", "deepseek-v2-236b", "--steps", "2",
            "--clients", "2"]
    want = _reference_lines(monkeypatch, capsys, "repro.launch.train", argv)
    params = train.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert re.fullmatch(STEP_LINE, g) and re.fullmatch(STEP_LINE, w)
        assert abs(float(g.split()[3]) - float(w.split()[3])) < 0.05
    assert params["stack"]["l0"]["moe"]["router"]["w"].dtype == \
        torch.float32


def test_serve_runs_mamba2(monkeypatch, capsys):
    """``--arch mamba2-2.7b`` serves from its SSM state and conv window
    (the decode recurrence) with no refusal: the reference's four lines,
    ids in [0, V), greedy ids the argmax of their logits."""
    import re

    from repro_torch.launch import serve

    argv = ["--arch", "mamba2-2.7b", "--gen", "4", "--batch", "2",
            "--prompt-len", "8"]
    want = _reference_lines(monkeypatch, capsys, "repro.launch.serve", argv)
    res = serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    assert got[0] == want[0] == "arch=mamba2-2.7b batch=2 prompt=8 gen=4"
    assert re.match(r"decode:  \d+\.\d ms \(\d+ tok/s\)", got[2])
    assert res.tokens.shape == (2, 4) and len(res.logits) == 4
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < 512
    assert torch_equal_greedy(res)


def test_lm_mode_trains_jamba(monkeypatch, capsys):
    """``--mode lm --arch jamba-1.5-large-398b --steps 1`` takes SCBF's
    federated step on the hybrid (Mamba + MLP, attention + MoE; bf16
    leaves, fp32 ``A_log``, ``D_res`` and router) with no refusal: the
    reference's ``step … loss …`` line, a loss near the reference's."""
    import re

    import torch

    from repro_torch.launch import train

    argv = ["--mode", "lm", "--arch", "jamba-1.5-large-398b", "--steps",
            "1", "--clients", "2"]
    want = _reference_lines(monkeypatch, capsys, "repro.launch.train", argv)
    params = train.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 1
    assert re.fullmatch(STEP_LINE, got[0]) and re.fullmatch(STEP_LINE,
                                                            want[0])
    assert abs(float(got[0].split()[3]) - float(want[0].split()[3])) < 0.05
    mamba = params["stack"]["l0"]["mamba"]
    assert mamba["A_log"].dtype == mamba["D_res"].dtype == torch.float32


ENCDEC_ARCHS = ["whisper-medium", "llama-3.2-vision-11b"]


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_serve_runs_the_encdec_archs(monkeypatch, capsys, arch):
    """``--arch whisper-medium`` (the encoder over the stub's zero frame
    embeddings, the decoder's cross caches) and ``--arch
    llama-3.2-vision-11b`` (zero patch embeddings) serve with no refusal:
    the reference's four lines, ids in [0, V), greedy ids the argmax of
    their logits."""
    import re

    from repro_torch.launch import serve

    argv = ["--arch", arch, "--gen", "4", "--batch", "2",
            "--prompt-len", "8"]
    want = _reference_lines(monkeypatch, capsys, "repro.launch.serve", argv)
    res = serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    assert got[0] == want[0] == f"arch={arch} batch=2 prompt=8 gen=4"
    assert re.match(r"decode:  \d+\.\d ms \(\d+ tok/s\)", got[2])
    assert res.tokens.shape == (2, 4) and len(res.logits) == 4
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < 512
    assert torch_equal_greedy(res)


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_lm_mode_trains_the_encdec_archs(monkeypatch, capsys, arch):
    """``--mode lm --arch whisper-medium`` / ``llama-3.2-vision-11b``
    takes SCBF's federated step with each client's (K, B, T, D) zero
    context embeddings, as the reference's launcher adds them: its ``step
    … loss …`` lines, a loss within 0.5 of the reference's (each package
    draws its own random weights, so the two losses differ by the spread
    of a random init about ln 512 ≈ 6.24, as the qwen2-0.5b case
    allows)."""
    import re

    from repro_torch.launch import train

    argv = ["--mode", "lm", "--arch", arch, "--steps", "2", "--clients",
            "2"]
    want = _reference_lines(monkeypatch, capsys, "repro.launch.train", argv)
    params = train.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert re.fullmatch(STEP_LINE, g) and re.fullmatch(STEP_LINE, w)
        assert abs(float(g.split()[3]) - float(w.split()[3])) < 0.5
    assert ("encoder" in params) == (arch == "whisper-medium")
    assert "cross" in params["stack"]["l1"]


def test_generate_needs_the_context_exactly_when_the_model_cross_attends():
    """``serve.generate`` refuses a cross-attending model without ``aux``
    and a text-only one with it."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo

    prompts = torch.zeros((1, 2), dtype=torch.int32)
    for arch, aux in (("whisper-medium", None),
                      ("qwen2-0.5b", torch.zeros((1, 4, 256)))):
        cfg = configs.smoke_variant(configs.get(arch))
        bundle = model_zoo.build(cfg, device="cpu")
        with pytest.raises(ValueError, match="aux"):
            generate(bundle, None, prompts, 2, 8, aux=aux)


def test_generate_follows_given_ids():
    """``serve.generate`` fed ``follow``: its own greedy ids give back the
    greedy run's ids and logits bitwise; other ids are fed as they are,
    and change the logits after the first step."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo

    cfg = configs.smoke_variant(configs.get("qwen2-0.5b"))
    bundle = model_zoo.build(cfg, device="cpu")
    params, _ = bundle.init(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 5),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    greedy = generate(bundle, params, prompts, 4, 16)
    again = generate(bundle, params, prompts, 4, 16, follow=greedy.tokens)
    assert torch.equal(again.tokens, greedy.tokens)
    for a, b in zip(again.logits, greedy.logits):
        assert torch.equal(a, b)
    other = (greedy.tokens + 1) % cfg.vocab_size
    fed = generate(bundle, params, prompts, 4, 16, follow=other)
    assert torch.equal(fed.tokens, other)
    assert torch.equal(fed.logits[0], greedy.logits[0])
    assert not torch.equal(fed.logits[1], greedy.logits[1])


def test_two_ranks_run_the_launcher_as_torchrun_would(tmp_path):
    """``launch.train.main`` on 2 spawned gloo ranks of one group (the
    environment torchrun gives: ``WORLD_SIZE`` 2): pods of 2, the same
    records on both ranks, and rank 0 alone writing — the CSVs and the
    event logs."""
    import _torch_pod_ranks as ranks
    from repro_torch.launch import mesh as pod

    out = str(tmp_path / "out")
    r0, r1 = pod.spawn_ranks(ranks.launch_train, 2, (out,), device="cpu",
                             timeout_s=60.0, join_timeout_s=240.0)
    assert r0["records"] == r1["records"]
    assert set(r0["records"]) == {"scbf", "fedavg"}
    assert all(len(v) == 2 for v in r0["records"].values())
    assert r1["written"] == []
    want = {f"{out}/{m}.csv" for m in ("scbf", "fedavg")} | \
        {f"{out}/{m}.events.jsonl" for m in ("scbf", "fedavg")}
    assert set(r0["written"]) == want
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        p.rsplit("/", 1)[1] for p in want)
