"""Dry run of the zoo on the production mesh: trace every (arch × shape ×
mesh) combination's step on DTensors, one device's share of it (the
counterpart of ``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi \\
        --compressed --tag compressed

One process stands for rank 0 of the production mesh's 256 (``single``,
``(data, model)`` = (16, 16)) or 512 (``multi``, (2, 16, 16) with
``pod``) ranks: a ``"fake"`` process group of that size, whose
collectives do nothing (the counterpart of the reference's
``--xla_force_host_platform_device_count=512``).  Params, inputs and
caches live on the meta device, each a DTensor whose local shard has
the rank's shape, so the step runs every op at its local shapes and
allocates nothing on any device, as the reference compiles without
running.  The kernels' wrappers trace their plain versions there.

The record's keys are the reference's where they still mean something:
``state_bytes_per_dev`` (the local shards of params, inputs and caches),
``memory`` (``argument_size_in_bytes``: that state;
``output_size_in_bytes``: the local shards of the step's outputs;
``temp_size_in_bytes``: the most the step's ops hold at once above the
state, ``launch.roofline.StepCounter``'s ``peak_bytes`` on the meta
device) and
``peak_bytes_per_dev`` (argument plus temp), ``flops_per_dev`` and
``bytes_per_dev`` (``StepCounter`` on the local ops), ``collectives``
(by kind; DTensor's redistributions and the port's SCBF exchange,
cross-pod and cross-node bytes apart) and the H100 roofline ``terms``.
With pods, each pod runs its own clients (training) or its own rows of
the batch (serving) on its ``(data, model)`` mesh, and exchanges SCBF's
dense masked update, or with ``--compressed`` (train shapes only) each
client's top-α channels (``core.distributed``).  Meta tensors hold no
scores, so how many selected channels fall in a rank's columns of a
column-split leaf cannot be read: the compressed record counts each
client's expected share, ceil(k · n_local / n) entries
(``compact_entries``), on every pod.  A combination that fails is
recorded ``ok: false`` with its error.  Records go under
``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch.distributed as dist

from repro_torch import configs
from repro_torch.comm import collectives
from repro_torch.config import HARDWARE, INPUT_SHAPES, ScbfConfig, ShapeConfig
from repro_torch.launch.roofline import StepCounter, roofline_terms
from repro_torch.models import model_zoo
from repro_torch.models import transformer as T
from repro_torch.params import tree_leaves
from repro_torch.sharding import mesh as meshes
from repro_torch.sharding.rules import (ShardingRules, distribute_params,
                                        make_shard_fn, place_inputs)

# dense/quadratic archs run long_500k with this sliding window
LONG_CONTEXT_WINDOW = 8192


def _decode_window(cfg, shape: ShapeConfig) -> int:
    if shape.name == "long_500k" and not cfg.supports_long_decode_natively:
        return LONG_CONTEXT_WINDOW
    return 0


def fake_group(world: int) -> None:
    """Make this process rank 0 of a ``"fake"`` group of ``world`` ranks
    (replacing a fake group of another size); a real group refuses."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               f"{dist.get_backend()} group is initialised")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tree_leaves(tree))


def _pod_share(shape: ShapeConfig, pods: int) -> ShapeConfig:
    """A pod's rows of a serving batch (the whole batch when the pods do
    not divide it, as the reference replicates it)."""
    if pods > 1 and shape.global_batch % pods == 0:
        return dataclasses.replace(shape,
                                   global_batch=shape.global_batch // pods)
    return shape


def dryrun_one(arch: str, shape_name: str, mesh_kind: str,
               federated: Optional[bool] = None,
               compressed: bool = False,
               q_chunk: int = 512,
               kv_quant: bool = False,
               fsdp: bool = True,
               moe_dshard: bool = False,
               moe_groups: int = 0,
               extra_tag: str = "",
               cfg=None) -> Dict[str, Any]:
    """Trace one combination; returns the result record.  ``cfg`` replaces
    ``configs.get(arch)`` (a smoke-width variant in the tests)."""
    shape = INPUT_SHAPES[shape_name]
    multi_pod = mesh_kind == "multi"
    if federated is None:
        federated = multi_pod and shape.kind == "train"
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "window": 0,
        "federated": bool(federated and shape.kind == "train"),
        "compressed": compressed, "kv_quant": kv_quant, "fsdp": fsdp,
        "q_chunk": q_chunk, "tag": extra_tag, "ok": False,
        "hardware": HARDWARE.name,
    }
    t0 = time.time()
    try:
        cfg = cfg or configs.get(arch)
        window = rec["window"] = _decode_window(cfg, shape)
        fake_group(512 if multi_pod else 256)
        mesh = meshes.make_production_mesh(multi_pod=multi_pod, device="cpu")
        pods = meshes.num_pods(mesh)
        data = mesh.size(mesh.mesh_dim_names.index("data"))
        fed_train = rec["federated"]
        local_shape = shape if fed_train else _pod_share(shape, pods)
        batch_shardable = local_shape.global_batch >= data
        shard_fn = make_shard_fn(
            mesh, batch_shardable,
            group_axes=("data",) if fed_train else None,
            batch_override=("data",) if fed_train else None)
        if moe_groups < 0:
            moe_groups = 1       # explicit off
        elif moe_groups == 0:    # default: one group a device of the batch
            moe_groups = data if (fed_train or batch_shardable) else 1
        bundle = model_zoo.build(cfg, shard=shard_fn, q_chunk=q_chunk,
                                 kv_quant=kv_quant, moe_dshard=moe_dshard,
                                 moe_groups=moe_groups, device="cpu")
        rec["moe_groups"] = moe_groups
        params, axes = T.init_model(cfg, None)            # meta
        params = distribute_params(params, axes, mesh,
                                   ShardingRules(fsdp=fsdp))
        specs = bundle.input_specs(local_shape, window=window)
        if fed_train:
            # a leading client axis over the pods; a pod takes its own
            specs = {k: v.reshape((pods, v.shape[0] // pods) + v.shape[1:])
                     for k, v in specs.items()}
            scbf = ScbfConfig(upload_rate=0.10,
                              compressed_exchange=compressed)
            if compressed:
                rec["compact_entries"] = "expected share: ceil(k * " \
                    "n_local / n) a client in a rank's columns"
            from repro_torch.core.distributed import make_federated_train_step
            step = make_federated_train_step(
                lambda p, b: bundle.loss_fn(p, b, window=window), scbf,
                mesh=mesh)
            state_in = _local_bytes(place_inputs(
                {k: v[0] for k, v in specs.items()}, mesh))
        else:
            specs = place_inputs(specs, mesh)
            state_in = _local_bytes(specs)
            if shape.kind == "train":
                step = bundle.train_step
            elif shape.kind == "prefill":
                def step(p, b):
                    return bundle.prefill_step(p, b, window=window)
            else:
                def step(p, b):
                    return bundle.decode_step(p, b, window=window)
        state = _local_bytes(params) + state_in
        collectives.reset_traffic()
        with StepCounter(mesh) as counter:
            out = step(params, specs)
        for (family, kind), (calls, _, n) in collectives.by_kind.items():
            # the production mesh's axes each span more than one node
            counter.add_collective(kind, n, cross_pod=family == "pod",
                                   cross_node=True, calls=calls)
        temp = counter.peak_bytes.get("meta", 0)
        terms = roofline_terms(counter.flops, counter.bytes,
                               counter.total_bytes,
                               cross_node_bytes=counter.cross_node_bytes,
                               dtype=cfg.dtype)
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        model_flops = 6.0 * cfg.active_param_count() * tokens
        chips = mesh.size()
        rec.update({
            "ok": True,
            "trace_s": round(time.time() - t0, 1),
            "state_bytes_per_dev": state,
            "memory": {"argument_size_in_bytes": state,
                       "output_size_in_bytes": _local_bytes(out),
                       "temp_size_in_bytes": temp},
            "peak_bytes_per_dev": state + temp,
            "flops_per_dev": counter.flops,
            "bytes_per_dev": counter.bytes,
            "collectives": counter.collectives(),
            "terms": terms,
            "tokens": tokens,
            "model_flops_total": model_flops,
            "useful_flops_ratio": (model_flops / (counter.flops * chips)
                                   if counter.flops else 0.0),
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
            "chips": chips,
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--compressed", action="store_true",
                    help="compressed SCBF cross-pod exchange (multi-pod "
                         "train; --all takes the train shapes only)")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (decode shapes)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate weights over the data axis")
    ap.add_argument("--moe-dshard", action="store_true",
                    help="d_model-sharded MoE dispatch/combine")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="grouped MoE routing (-1 off, 0 auto, N groups)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    combos = []
    if args.all:
        for arch in configs.ASSIGNED:
            for shape, sc in INPUT_SHAPES.items():
                if sc.kind == "train" or not args.compressed:
                    combos.append((arch, shape, args.mesh))
    else:
        combos.append((args.arch, args.shape, args.mesh))

    records = []
    for arch, shape, mesh_kind in combos:
        rec = dryrun_one(arch, shape, mesh_kind, compressed=args.compressed,
                         q_chunk=args.q_chunk,
                         kv_quant=args.kv_quant, fsdp=not args.no_fsdp,
                         moe_dshard=args.moe_dshard,
                         moe_groups=args.moe_groups, extra_tag=args.tag)
        tag = f"_{args.tag}" if args.tag else ""
        fname = f"{arch}_{shape}_{mesh_kind}{tag}.json"
        with open(os.path.join(args.out, fname), "w") as f:
            json.dump(rec, f, indent=1)
        status = "OK " if rec["ok"] else "FAIL"
        extra = (f"dom={rec['terms']['dominant']}" if rec["ok"]
                 else rec.get("error", "")[:120])
        print(f"[{status}] {arch} {shape} {mesh_kind} "
              f"({rec['total_s']}s) {extra}", flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
