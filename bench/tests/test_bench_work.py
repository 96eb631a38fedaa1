"""The yardstick's counts of work against counts made by hand."""
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for _p in (str(BENCH), str(BENCH.parent / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import work  # noqa: E402


def _config(name):
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_mlp_loop_counts_by_hand():
    c = _config("mlp-medical")
    f = c["features"]
    # 2917·256 + 256·64 + 64·1 weights; 5 clients × 14 full batches of 256
    # (a shard of 18,455 // 5 = 3,691 drops its tail of 107) × 2 epochs
    assert work.mlp_weights(f) == 763_200
    assert work.mlp_trained_rows(3691, c["batch"], c["local_epochs"],
                                 c["clients"]) == 35_840
    assert work.mlp_loop_flops(f, 3691, 256, 2, 5) == 164_118_528_000
    # a forward pass over the 9,228 test rows
    assert work.mlp_eval_flops(f, 9228) == 14_085_619_200


def test_mlp_kernel_bytes_by_hand():
    f = (2917, 256, 64, 1)
    # K1: 5 slots × 763,200 fp32 entries read, their row and column norms
    # (5 × 3,558 fp32) written
    assert work.k1_mlp_bytes(f, 5) == 4 * 3_816_000 + 4 * 17_790
    # K3: 10 uploads of 763,200 entries read, a count a (leaf, upload),
    # 1,000 compacted entries written as index and value
    assert work.k3_mlp_bytes(f, 10, 1000) == 4 * 7_632_000 + 4 * 30 + 8000


def test_lm_counts_from_the_leaf_shapes():
    from repro_torch.config import ArchConfig
    from repro_torch.models import transformer as T

    from harness.registry import load_module
    flatten = load_module(BENCH / "drivers" / "lm_fedstep.py",
                          "bench_driver").flatten
    # DeepSeek-V2 at the widths the port builds, two layers (the dense
    # prefix layer and one MoE layer)
    arch = ArchConfig(
        name="deepseek-v2-d2", family="moe", source="arXiv:2405.04434",
        num_layers=2, d_model=5120, num_heads=128, num_kv_heads=128,
        head_dim=128, d_ff=1536, vocab_size=102400, use_mla=True,
        kv_lora_rank=512, qk_rope_dim=64, num_experts=160,
        num_shared_experts=2, experts_per_token=6, first_dense_layers=1,
        dtype="bfloat16")
    tree, _ = T.init_model(arch, None)
    leaves = [(n, tuple(v.shape)) for n, v in flatten(tree)]
    assert sum(math.prod(s) for _, s in leaves) == 5_353_956_352
    # unembed 524,288,000; two MLA blocks of 229,441,536 (q 125,829,120,
    # kv_down 2,949,120, kv_up 16,777,216, o 83,886,080); the dense SwiGLU
    # 23,592,960; the router 819,200, 6 of 160 experts 141,557,760 and the
    # shared experts 47,185,920
    active = work.lm_active_params(leaves, 160, 6)
    assert active == 1_196_326_912
    # 3 × 2 layers × 2 × 128 heads × (192 + 128) × 257 / 2 keys at S = 256
    att = work.lm_attention_flops_per_token(2, 128, 192, 128, 256)
    assert att == 63_160_320
    assert work.lm_flops_per_token(active, att) == 7_241_121_792


def test_lm_kernel_bytes_by_hand():
    import torch
    leaves = [("a.w", (4, 6), torch.bfloat16), ("b.scale", (6,),
                                                 torch.bfloat16),
              ("c.w", (1, 2, 3), torch.float32)]
    t = work.lm_score_tables(leaves, 2)
    assert t == {2: [(2, 4, 6)], 4: [(2, 2, 3)]}
    # K1: 2·(2·4·6) + 4·2·(4+6), then 4·(2·2·3) + 4·2·(2+3)
    assert work.k1_lm_bytes(list(t.values()), list(t)) == 96 + 80 + 48 + 40
    # K2: 2·2·48 + 4·(4 + 12) + 8 + (8 + 4); 2·4·12 + 4·(2 + 6) + 8 + 12
    assert work.k2_lm_bytes(list(t.values()), list(t)) == \
        192 + 64 + 8 + 12 + 96 + 32 + 8 + 12


def test_roofline_share_is_the_bound_over_the_time():
    kind = "NVIDIA H100 80GB HBM3"
    assert work.roofline_share(3.35e9, 0.0, 2e-3, kind) == 50.0
    assert math.isclose(work.roofline_share(0.0, 67e9, 1e-3, kind), 100.0)


def test_upload_gaps_a_client_each():
    import numpy as np

    from harness import compare
    want = [[{"w": np.full((2, 3), 2.0), "b": np.ones(3)}] for _ in range(5)]
    got = [[{k: v.copy() for k, v in layer.items()} for layer in up]
           for up in want]
    got[0][0]["w"] *= -1.0                   # one client's upload negated
    got[1][0]["b"][0] = 0.0                  # an entry one side dropped
    gaps = compare.upload_gaps(got, want)
    assert gaps == [2.0, 0.0, 0.0, 0.0, 0.0]
    assert float(np.median(gaps)) == 0.0
    assert compare.upload_gaps(got[:4], want) == [float("inf")]
