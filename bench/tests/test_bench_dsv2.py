"""The benchmark's DeepSeek-V2 parts on the CPU: a toy-width
``dsv2_fedstep`` cell added to a copy of the benchmark by files and
entries alone runs correct under the real cell's limits, and each planted
fault comes out not correct; the step's spans nest as designed in a
profiled run; ``mfu.dsv2``'s FLOPs are a hand count; the span readers
read busy time under the spans' device extents, and nothing where the
window holds none."""
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_tiny import BENCH, _dump, _load, run_cell, tiny_bench  # noqa: E402
from dsv2_faults import FAULTS, planted  # noqa: E402

CELL = "dsv2-fedstep-s256"
TOY = "dsv2-toy-step"
# every mechanism of the published model at toy widths: q-lora, the
# latent's norm, YaRN, a dense width unlike d_ff, 8 router groups with the
# top 3 kept, gates scaled by 16, a quarter of the experts held
TOY_PORT = {"name": "dsv2-toy", "family": "moe", "source": "a toy size",
            "num_layers": 3, "d_model": 64, "num_heads": 4,
            "num_kv_heads": 4, "head_dim": 16, "d_ff": 32,
            "dense_d_ff": 96, "vocab_size": 128, "use_mla": True,
            "kv_lora_rank": 16, "q_lora_rank": 24, "qk_rope_dim": 8,
            "mla_kv_norm": True, "yarn_factor": 40.0,
            "yarn_original_len": 4096, "yarn_beta_fast": 32.0,
            "yarn_beta_slow": 1.0, "yarn_mscale": 0.707,
            "yarn_mscale_all_dim": 0.707, "num_experts": 16,
            "num_shared_experts": 2, "experts_per_token": 4,
            "moe_every": 1, "first_dense_layers": 1,
            "moe_capacity_factor": 1.25, "router_expert_groups": 8,
            "router_topk_groups": 3, "router_norm_topk": False,
            "router_scale": 16.0, "experts_held": 4, "experts_offset": 0,
            "rope_theta": 10000.0, "dtype": "float32"}
READERS = ("grad_ms.dsv2", "select_ms.dsv2", "update_ms.dsv2", "mla_ms.dsv2",
           "route_ms.dsv2", "experts_ms.dsv2", "mlp_ms.dsv2",
           "idle_unspanned.dsv2")


def add_toy_cell(tmp: Path) -> Path:
    """A copy of the benchmark with the toy cell beside the real one, under
    the real cell's limits and metrics."""
    bench = tiny_bench(tmp)
    real = _load(BENCH / "cells" / f"{CELL}.json")
    _dump({"name": "dsv2-toy", "port": TOY_PORT,
           "federated": _load(BENCH / "configs" / "dsv2-ep8-stage.json")
           ["federated"]}, bench / "configs" / "dsv2-toy.json")
    _dump(dict(real, config="dsv2-toy", traffic="tiny-tokens"),
          bench / "cells" / f"{TOY}.json")
    spec = _load(tmp / "BENCHMARK.json")
    spec["configs"].append({"name": "dsv2-toy", "source": "a toy size",
                            "file": "bench/configs/dsv2-toy.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": TOY, "config": "dsv2-toy",
                              "traffic": "tiny-tokens", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TOY)
    _dump(spec, tmp / "BENCHMARK.json")
    return bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return add_toy_cell(tmp_path_factory.mktemp("bench"))


def test_the_toy_cell_runs_and_is_correct(bench):
    out = run_cell(bench, TOY)
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "loop_ms"}
    assert out["metrics"]["loop_ms"]["value"] > 0
    limits = _load(BENCH / "cells" / f"{CELL}.json")["limits"]
    assert set(out["checks"]) == set(limits)
    for name, c in out["checks"].items():
        # the port and the plain reference agree at a toy size in fp32 to
        # rounding, far inside the card's limits
        assert c["limit"] == limits[name]
        assert math.isfinite(c["value"]) and c["value"] < 1e-4, name


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(bench, fault):
    with planted(fault):
        out = run_cell(bench, TOY)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_control_fails_at_a_toy_size(bench):
    """The readings tool knows the driver (``dsv2_readings``, through
    ``conftest.py``): its faults, and a control in fp8 that comes out not
    correct under the real cell's limits."""
    import bench_readings
    from harness import registry
    limits = _load(BENCH / "cells" / f"{CELL}.json")["limits"]
    assert bench_readings.faults_for(registry.find_cell(TOY, bench)) == FAULTS
    got = bench_readings.readings(TOY, 2150000001, ["control"], bench=bench,
                                  device="cpu")["control"]
    assert any(v > limits[k] for k, v in got.items() if k in limits), got


def test_the_spans_nest_as_designed():
    """One step under the profiler: each client's ``client_grad`` holds its
    model spans, forward and remat's recompute (the dense layer is not
    recomputed: it is no stacked unit); ``select`` and ``sum_update``
    follow outside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ArchConfig, ScbfConfig
    from repro_torch.core import distributed as dist
    from repro_torch.models import model_zoo
    cfg = ArchConfig(**TOY_PORT)
    bundle = model_zoo.build(cfg, device="cpu")
    params = bundle.init(0)[0]
    toks = torch.randint(0, 128, (2, 2, 17), generator=torch.Generator()
                         .manual_seed(0), dtype=torch.int32)
    step = dist.make_federated_train_step(
        bundle.loss_fn, ScbfConfig(upload_rate=0.1, num_clients=2))
    names = {"client_grad", "select", "sum_update", "mla", "moe.route",
             "moe.experts", "mlp"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, {"tokens": toks[..., :-1], "targets": toks[..., 1:]})
    ev = sorted(((e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name in names),
                key=lambda e: e[1])
    count = {n: sum(e[0] == n for e in ev) for n in names}
    # 2 clients: 3 MLA layers forward and the 2 stacked ones again; the
    # dense MLP and 2 shared experts forward, the 2 shared again
    assert count == {"client_grad": 2, "select": 1, "sum_update": 1,
                     "mla": 10, "moe.route": 8, "moe.experts": 8, "mlp": 10}
    grads = [e for e in ev if e[0] == "client_grad"]
    outer = {"client_grad", "select", "sum_update"}
    for n, a, b in ev:
        if n not in outer:
            assert any(ga <= a and b <= gb for _, ga, gb in grads), n
    sel = next(e for e in ev if e[0] == "select")
    upd = next(e for e in ev if e[0] == "sum_update")
    assert grads[-1][2] <= sel[1] and sel[2] <= upd[1]


def test_mfu_flops_are_a_hand_count():
    from harness import work_dsv2
    D, F, V, ql, r, rd, H, hd = 8, 4, 10, 6, 3, 2, 2, 5
    leaves = [("embed.w", (V, D)), ("prefix.p0.attn.q_a.w", (D, ql)),
              ("prefix.p0.attn.q_norm.scale", (ql,)),
              ("prefix.p0.attn.q_b.w", (ql, H * (hd + rd))),
              ("prefix.p0.attn.kv_down.w", (D, r + rd)),
              ("prefix.p0.attn.kv_up.w", (r, H * 2 * hd)),
              ("prefix.p0.attn.o.w", (H * hd, D)),
              ("prefix.p0.mlp.wi.w", (D, 12)),
              ("stack.l0.moe.router.w", (1, D, 16)),
              ("stack.l0.moe.wi", (1, 4, D, F)),
              ("stack.l0.moe.wg", (1, 4, D, F)),
              ("stack.l0.moe.wo", (1, 4, F, D)),
              ("stack.l0.moe.shared.wi.w", (1, D, 2 * F)),
              ("unembed.w", (D, V))]
    dense = (D * ql + ql * H * 7 + D * 5 + r * H * 10 + H * hd * D + D * 12
             + D * 16 + D * 2 * F + D * V)
    seq, tokens, kept = 4, 16, 9.0
    attention = 3 * 2 * 2 * H * (hd + rd + hd) * (seq + 1) / 2
    want = tokens * (6 * dense + attention) + 18 * D * F * kept
    got = work_dsv2.step_flops(leaves, tokens, seq, 2, H, hd + rd, hd, D, F,
                               kept)
    assert got == pytest.approx(want, rel=1e-12)


def _reader(name):
    from harness import registry
    return registry.load_module(BENCH / "layer_metrics" / f"{name}.py",
                                "bench_metric")


def _window(ops, spans=None):
    from harness.trace import Window
    w = Window(ops=ops, host=[], start_us=0.0, end_us=1000.0)
    if spans is not None:
        w.device_spans = spans
    return w


@pytest.mark.parametrize("name", READERS + ("mfu.dsv2",))
def test_a_reader_reads_nothing_without_spans(name):
    ops = [("k", 0.0, 100.0)]
    for w in (_window(ops), _window(ops, [])):
        ctx = {"window": w, "steps": 2, "kind": "NVIDIA H100 80GB HBM3"}
        assert _reader(name).read(ctx) is None


def test_a_span_reader_reads_busy_time_under_the_extents():
    ops = [("a", 0.0, 100.0), ("b", 150.0, 300.0), ("c", 250.0, 400.0),
           ("d", 600.0, 700.0)]
    spans = [("client_grad", 50.0, 350.0), ("client_grad", 320.0, 380.0),
             ("select", 600.0, 650.0), ("mla", 0.0, 10.0)]
    ctx = {"window": _window(ops, spans), "steps": 2}
    # ops' union [0,100] [150,400] [600,700]; client_grad covers [50,380]:
    # 50 + 230 us, a step 140 us
    assert _reader("grad_ms.dsv2").read(ctx) == pytest.approx(0.140)
    assert _reader("select_ms.dsv2").read(ctx) == pytest.approx(0.025)
    assert _reader("mla_ms.dsv2").read(ctx) == pytest.approx(0.005)
    assert _reader("update_ms.dsv2").read(ctx) is None


def test_mfu_reads_the_slot_counter():
    arch = SimpleNamespace(num_layers=2, num_heads=2, head_dim=5,
                           qk_rope_dim=2, d_model=8, d_ff=4)
    leaves = [("stack.l0.moe.wi", (1, 4, 8, 4), None),
              ("unembed.w", (8, 10), None)]
    w = _window([("k", 0.0, 1000.0)], [])
    ctx = {"window": w, "steps": 3, "kind": "NVIDIA H100 80GB HBM3",
           "arch": arch, "leaves": leaves, "tokens_per_step": 16, "seq": 4,
           "routed_slots": 12.0, "dropped_slots": 3.0}
    flops = 3 * (16 * (6 * 80 + 3 * 2 * 2 * 2 * 12 * 2.5) + 18 * 8 * 4 * 9)
    assert _reader("mfu.dsv2").read(ctx) == pytest.approx(
        100 * flops / (1e-3 * 989e12))


def test_idle_unspanned_reads_the_gaps_outside_every_extent():
    ops = [("a", 0.0, 100.0), ("b", 200.0, 300.0), ("c", 700.0, 800.0)]
    spans = [("client_grad", 50.0, 350.0), ("mla", 120.0, 130.0),
             ("select", 600.0, 750.0)]
    ctx = {"window": _window(ops, spans), "steps": 1}
    # gaps [100,200] (under client_grad), [300,700] (middle 500: none),
    # [800,1000] (none): 600 of 700 us
    assert _reader("idle_unspanned.dsv2").read(ctx) == pytest.approx(
        100 * 600 / 700)


def test_gemm_ms_reads_the_product_kernels_a_step():
    ops = [("sm90_xmma_gemm_bf16", 0.0, 100.0), ("cutlass_80_simt", 150.0,
                                                  250.0),
           ("elementwise", 300.0, 900.0)]
    ctx = {"window": _window(ops, []), "steps": 2}
    assert _reader("gemm_ms.dsv2").read(ctx) == pytest.approx(0.1)


@pytest.mark.parametrize("seed", range(6))
def test_the_span_window_breaks_down_as_the_window(seed):
    """``SpanWindow.breakdown`` equals ``Window.breakdown`` exactly: gaps
    whose middle sits on a host event's bound, host events of equal
    length, nested ones, the window's own annotation, none at all."""
    import random

    from harness.device_spans import SpanWindow
    from harness.trace import WINDOW, Window
    rnd = random.Random(seed)
    ops, at = [], 0.0
    for i in range(300):
        at += rnd.choice((0.0, 1.0, 2.0, 5.0))
        d = rnd.choice((1.0, 3.0, 8.0))
        ops.append((f"k{i % 7}", at, at + d))
        at += d * rnd.choice((0.5, 1.0))
    host = [(WINDOW, 0.0, at + 10.0)]
    for i in range(400 * (seed > 0)):
        a = float(rnd.randrange(0, int(at)))
        host.append((f"h{i % 13}", a, a + rnd.choice((0.5, 1.0, 2.0, 4.0,
                                                     30.0, 200.0))))
    kw = dict(ops=ops, host=host, start_us=0.0, end_us=at + 10.0)
    want = Window(**kw).breakdown(top=50)
    assert SpanWindow(**kw).breakdown(top=50) == want
    assert SpanWindow(**kw).breakdown() == Window(**kw).breakdown()
