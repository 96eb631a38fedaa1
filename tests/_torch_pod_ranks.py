"""Rank bodies of ``tests/test_torch_pods.py``: each runs on one spawned
rank of a gloo group (``repro_torch.launch.mesh.spawn_ranks``), computes
the one-device run in the same process for comparison, and returns
picklable results for the test to check.  No JAX here: a rank imports
torch and the port only."""
import dataclasses

import numpy as np
import torch

from repro_torch.config import FedConfig, ScbfConfig, TrainConfig
from repro_torch.comm import collectives
from repro_torch.launch import mesh as pod
from repro_torch.sharding import mesh as meshes

COLLECTIVES = ("gather_slots", "all_reduce_sum", "all_gather_compact")


class CollectiveTap:
    """Record every tensor that enters one of ``comm.collectives``' pod
    helpers (the callers reach them through the module) while active:
    ``seen`` holds ``(helper, [tensors])`` in call order."""

    def __init__(self):
        self.seen = []
        self._real = {}

    def __enter__(self):
        for name in COLLECTIVES:
            real = self._real[name] = getattr(collectives, name)

            def wrapped(*args, _real=real, _name=name, **kw):
                self.seen.append((_name, [a.detach().clone() for a in args
                                          if isinstance(a, torch.Tensor)]))
                return _real(*args, **kw)
            setattr(collectives, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(collectives, name, real)


def masked_within_masks(seen) -> dict:
    """The SCBF round's privacy check over ``gather_slots`` calls: every
    float tensor shaped like a slot-stacked parameter is zero outside the
    bool mask gathered for the same leaf (the next bool tensor of its
    shape), and each tensor is a parameter-shaped float, its mask, or a
    carry field (at most 2-D and never of the data's width).  Returns
    counts, and the violations found."""
    calls = [ts[0] for name, ts in seen if name == "gather_slots"]
    floats = [t for t in calls if t.is_floating_point() and t.ndim >= 2]
    bools = [t for t in calls if t.dtype == torch.bool]
    bad, masked_out = [], 0
    for t in floats:
        mask = next((m for m in bools if m.shape == t.shape), None)
        if mask is None:
            bad.append(f"{tuple(t.shape)} has no mask")
            continue
        bools.remove(mask)
        if torch.any((t != 0) & ~mask):
            bad.append(f"{tuple(t.shape)} nonzero outside its mask")
        masked_out += int(torch.count_nonzero(~mask))
    return {"calls": len(calls), "checked": len(floats),
            "masked_out": masked_out, "bad": bad,
            "others": sorted({(str(t.dtype), tuple(t.shape)) for t in calls
                              if not (t.is_floating_point() and t.ndim >= 2)
                              and t.dtype != torch.bool})}


def _clients():
    rng = np.random.default_rng(0)
    return [(rng.random((16, 8)).astype(np.float32),
             (rng.random(16) < .5).astype(np.float32)) for _ in range(4)]


def _perms(gen, n_parts, n=16):
    return [[torch.randperm(n, generator=gen)] for _ in range(n_parts)]


def engine_contracts(rank, world):
    """The reference's two pod scripts (``tests/test_fed_engine.py`` and
    ``tests/test_fused_rounds.py``) on the port: a round of P in {1, 3, 4}
    participants and a fused chunk of rounds [0..3], [0, 2] and empty, at
    ``pods = world`` and on one device; the per-round path's collectives
    recorded.  Returns payloads, stats and params of both."""
    from repro_torch.fed.engine import make_engine
    from repro_torch.models.mlp_net import init_mlp

    torch.set_num_threads(2)
    clients = _clients()
    params = init_mlp((8, 6, 1), torch.Generator().manual_seed(1), "cpu")
    cfg = ScbfConfig(upload_rate=0.25, num_clients=4)
    one = make_engine("batched", clients, 8, 1, "cpu", pods=1)
    many = make_engine("batched", clients, 8, 1, "cpu", pods=world)
    gen = torch.Generator().manual_seed(0)
    rounds = []
    collectives.reset_traffic()
    with CollectiveTap() as tap:
        for P in (1, 3, 4):
            part = np.arange(P)
            perms = _perms(gen, P)
            rounds.append((P, one.scbf_round(params, part, 0.1, perms, cfg),
                           many.scbf_round(params, part, 0.1, perms, cfg)))
    traffic = (collectives.calls, collectives.bytes_sent)
    parts = [np.arange(4), np.array([0, 2]), np.array([], dtype=np.int64)]
    perms = [_perms(gen, p.size) for p in parts]
    fused = {}
    with CollectiveTap() as fused_tap:
        for label, eng in (("one", one), ("many", many)):
            plan = eng.prepare_fused_plan(
                parts, [0.1] * 3, perms, horizon=4,
                num_slots=eng.fused_num_slots(4))
            new_p, out = eng.fused_scbf_chunk(params, plan, cfg)
            fused[label] = (eng.emit_fused_payloads(out, plan),
                            _np_params(new_p), plan.num_slots)
    return {"rounds": rounds, "fused": fused,
            "privacy": masked_within_masks(tap.seen),
            "fused_privacy": masked_within_masks(fused_tap.seen),
            "traffic": traffic}


def _np_params(params):
    return [{k: v.numpy().copy() for k, v in layer.items()}
            for layer in params]


# ---------------------------------------------------------------------------
# run_federated at pods = world, beside the one-device run
# ---------------------------------------------------------------------------

FEATS = (64, 32, 16, 1)
SAMPLED_CHANNELS = 16
CLIENTS = 5
PRUNE = dict(prune=True, prune_rate=0.25, prune_total=0.4)


def run_config(scbf=None, fed=None, loops=2, lr=0.01, collect=False):
    from repro_torch.config import ObsConfig
    return TrainConfig(learning_rate=lr, global_loops=loops, local_epochs=1,
                       local_batch_size=64, seed=0,
                       scbf=ScbfConfig(num_clients=CLIENTS, **(scbf or {})),
                       fed=FedConfig(**(fed or {})),
                       obs=ObsConfig(device_metrics=collect))


RUNS = {
    "scbf": ("scbf", run_config()),
    "fedavg": ("fedavg", run_config(lr=0.05)),
    "scbfwp-mask": ("scbf", run_config(
        dict(PRUNE, prune_impl="mask", prune_compact=True), loops=3)),
    "scbf-dp": ("scbf", run_config(dict(dp_noise_multiplier=0.3,
                                        dp_clip_norm=1.0))),
    "scbf-sampled-collect": ("scbf", run_config(
        fed=dict(sample_fraction=0.6), loops=3, collect=True)),
    "fedbuff": ("scbf", run_config(
        fed=dict(mode="fedbuff", concurrency=4, buffer_size=2,
                 straggler_rate=0.3), loops=3)),
    "scbf-fused": ("scbf", run_config(fed=dict(fuse_rounds=2), loops=4,
                                      collect=True)),
    # past SAMPLED_CHANNELS channels the threshold samples channels, drawn
    # for one device's bucket (5 slots) whatever the pods (6 slots)
    "scbf-sampled-quantile": ("scbf", run_config()),
    "scbf-sampled-quantile-fused": ("scbf", run_config(
        fed=dict(fuse_rounds=2), loops=4)),
    "fedavg-fused": ("fedavg", run_config(fed=dict(fuse_rounds=2), loops=2,
                                          lr=0.05)),
    "scbfwp-mask-fused": ("scbf", run_config(
        dict(PRUNE, prune_impl="mask", prune_compact=True),
        fed=dict(fuse_rounds=2), loops=4)),
}


def _records(res):
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k != "wall_time"} for r in res.records]


def run_cases(rank, world, labels):
    """``run_federated`` of each case of ``RUNS`` in ``labels`` on one
    device and at ``pods = world``; then the refusals a group allows:
    the sequential engine with pods, and pods other than the world
    size."""
    from repro_torch.core.scbf import run_federated
    from repro_torch.data.medical import generate_cohort

    torch.set_num_threads(2)
    cohort = generate_cohort(num_admissions=1500, num_medicines=64, seed=0)
    out = {}
    from repro_torch.core import channels

    materialized = channels.MAX_MATERIALIZED
    for label in labels:
        method, cfg = RUNS[label]
        channels.MAX_MATERIALIZED = SAMPLED_CHANNELS if "sampled-quantile" \
            in label else materialized
        got = []
        for pods in (1, world):
            c = dataclasses.replace(cfg, fed=dataclasses.replace(
                cfg.fed, pods=pods))
            res = run_federated(cohort, c, method=method,
                                mlp_features=FEATS, device="cpu")
            got.append((_records(res), _np_params(res.final_params)))
        out[label] = got
    refusals = {}
    for label, fed in (("sequential", FedConfig(engine="sequential",
                                                pods=world)),
                       ("world", FedConfig(pods=world + 1))):
        try:
            run_federated(cohort, dataclasses.replace(run_config(loops=1),
                                                      fed=fed),
                          mlp_features=FEATS, device="cpu")
            refusals[label] = None
        except (ValueError, RuntimeError) as e:
            refusals[label] = (type(e).__name__, str(e))
    out["refusals"] = refusals
    return out


# ---------------------------------------------------------------------------
# the federated LM step at pods = world
# ---------------------------------------------------------------------------

LM_K, LM_B, LM_S = 4, 2, 16


def lm_batch(vocab: int, k_clients: int = LM_K, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(k_clients, LM_B, LM_S + 1))
    return {"tokens": toks[..., :-1].astype(np.int32),
            "targets": toks[..., 1:].astype(np.int32)}


def lm_model(dtype: str):
    from repro_torch import configs
    from repro_torch.models import model_zoo

    cfg = dataclasses.replace(
        configs.smoke_variant(configs.get("qwen2-0.5b")), dtype=dtype)
    bundle = model_zoo.build(cfg, device="cpu")
    params, _ = bundle.init(0)
    return cfg, bundle, params


def lm_cases(rank, world, dtypes):
    """``lm_case`` of each dtype; two threads a rank (the ranks share the
    host's cores)."""
    torch.set_num_threads(2)
    return {dtype: lm_case(world, dtype) for dtype in dtypes}


def lm_case(world, dtype):
    """A dense and a compressed federated step of the qwen2 smoke variant,
    K = 4 clients, on one device and over the pod mesh, each from the
    same params and batch, with the pod steps' collectives recorded and
    checked (``_lm_privacy``); and a batch of K = 3 (not a multiple of
    the pods) refused."""
    from repro_torch.core.distributed import make_federated_train_step
    from repro_torch.params import tree_leaves

    cfg, bundle, params = lm_model(dtype)
    mesh = meshes.make_pod_mesh(world, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in lm_batch(cfg.vocab_size).items()}
    out = {}
    for compressed in (False, True):
        scbf = ScbfConfig(upload_rate=0.10, compressed_exchange=compressed)
        one = make_federated_train_step(bundle.loss_fn, scbf, lr=0.05)
        many = make_federated_train_step(bundle.loss_fn, scbf, lr=0.05,
                                         mesh=mesh)
        l1, p1 = one(params, batch)
        collectives.reset_traffic()
        with CollectiveTap() as tap:
            lp, pp = many(params, batch)
        out[compressed] = {
            "loss": (float(l1), float(lp)),
            "params": ([t.float().numpy() for t in tree_leaves(p1)],
                       [t.float().numpy() for t in tree_leaves(pp)]),
            "dtypes": ([str(t.dtype) for t in tree_leaves(p1)],
                       [str(t.dtype) for t in tree_leaves(pp)]),
            "privacy": _lm_privacy(tap.seen, bundle, params, batch, scbf,
                                   mesh),
            "traffic": (collectives.calls, collectives.bytes_sent)}
    three = {k: v[:3] for k, v in batch.items()}
    try:
        make_federated_train_step(bundle.loss_fn, ScbfConfig(), mesh=mesh)(
            params, three)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def _lm_privacy(seen, bundle, params, batch, scbf, mesh) -> dict:
    """What crossed in a pod step, against this rank's own clients.

    Dense: the 0-d loss sum, then every leaf's fp32 partial sum of the
    rank's clients' masked gradients (recomputed here, bitwise) — each
    scored leaf's with channels the raw sum has and it has not.
    Compressed: ``all_gather_compact`` pairs (int64 idx (k, c), fp32 vals
    (k, ..., c) with c < the leaf's width), the 0-d loss sum and vector
    leaves' sums; nothing else."""
    from repro_torch.core import channels
    from repro_torch.core.distributed import _local_clients, client_gradients
    from repro_torch.params import tree_leaves

    _, grads = client_gradients(bundle.loss_fn, params,
                                _local_clients(batch, mesh))
    leaves = tree_leaves(grads)
    bad = []
    if not scbf.compressed_exchange:
        masked, _ = channels.apply_factored_mask_slots(
            grads, scbf.upload_rate, scbf.selection)
        names = [name for name, _ in seen]
        sent = [ts[0] for _, ts in seen]
        if set(names) != {"all_reduce_sum"} or sent[0].ndim != 0:
            bad.append(f"calls {names[:3]}…")
        hidden = 0
        for leaf, m, t in zip(leaves, tree_leaves(masked), sent[1:]):
            want = torch.sum(m, axis=0, dtype=torch.float32)
            if not torch.equal(t, want):
                bad.append(f"{tuple(t.shape)} is not the masked sum")
            if leaf.ndim >= 3:
                raw = torch.sum(leaf, axis=0, dtype=torch.float32)
                hidden += int(torch.any((raw != 0) & (t == 0)))
        return {"checked": len(sent) - 1, "leaves": len(leaves),
                "scored": sum(t.ndim >= 3 for t in leaves),
                "scored_with_hidden_entries": hidden, "bad": bad}
    pairs = vectors = 0
    for name, ts in seen:
        if name == "all_gather_compact":
            idx, vals = ts
            ok = (idx.dtype == torch.int64 and idx.ndim == 2
                  and vals.dtype == torch.float32
                  and vals.shape[0] == idx.shape[0]
                  and vals.shape[-1] == idx.shape[-1]
                  and any(vals.shape[1:-1] == leaf.shape[1:-1]
                          and idx.shape[-1] < leaf.shape[-1]
                          for leaf in leaves))
            pairs += 1
            if not ok:
                bad.append(f"compact {tuple(idx.shape)} {tuple(vals.shape)}")
        elif name == "all_reduce_sum":
            t = ts[0]
            vectors += t.ndim == 1
            if t.ndim > 1 or (t.ndim == 1 and not any(
                    leaf.ndim == 2 and leaf.shape[1:] == t.shape
                    for leaf in leaves)):
                bad.append(f"dense {tuple(t.shape)}")
        elif name == "gather_slots":
            pass                       # inside all_gather_compact
        else:
            bad.append(name)
    return {"pairs": pairs, "vectors": vectors,
            "scored": sum(t.ndim >= 3 for t in leaves), "bad": bad}


def fail_on_last(rank, world):
    """Rank world-1 raises; the others wait for it at a barrier."""
    if rank == world - 1:
        raise ValueError("rank failed on purpose")
    torch.distributed.barrier()
    return rank


def launch_train(rank, world, out):
    """``launch.train.main`` as a torchrun rank of the group (a small
    cohort in place of the paper's): every file this rank opens for
    writing, and its records."""
    import builtins

    import repro_torch.data.medical as medical
    from repro_torch.launch import train

    torch.set_num_threads(2)
    real = medical.generate_cohort
    medical.generate_cohort = lambda seed=0: real(
        num_admissions=1500, num_medicines=64, seed=seed)
    written, real_open = [], builtins.open

    def tracking_open(file, mode="r", *args, **kw):
        if any(m in mode for m in "wax"):
            written.append(str(file))
        return real_open(file, mode, *args, **kw)

    builtins.open = tracking_open
    try:
        res = train.main(["--methods", "scbf,fedavg", "--loops", "2",
                          "--clients", "4", "--device", "cpu", "--events",
                          "--local-epochs", "1", "--batch-size", "64",
                          "--out", out])
    finally:
        builtins.open = real_open
    return {"written": sorted(written),
            "records": {m: _records(r) for m, r in res.items()}}


# ---------------------------------------------------------------------------
# the (data, model) mesh (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------

MESH_B, MESH_P, MESH_T, MESH_CACHE = 4, 8, 4, 10   # batch, prompt, decode


def _mesh_cfg(arch: str, cfg_kw: dict):
    from repro_torch import configs
    return dataclasses.replace(configs.smoke_variant(configs.get(arch)),
                               dtype="float32", **cfg_kw)


def _serve(bundle, params, toks):
    """Prefill ``MESH_P`` tokens into caches of ``MESH_CACHE`` slots, then
    ``MESH_T`` decode steps (the ring wraps): every step's logits, full
    tensors in numpy, and the types of the last caches' leaves."""
    from repro_torch.params import tree_leaves
    from torch.distributed.tensor import DTensor

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()
    t = torch.from_numpy(toks)
    logits, caches = bundle.prefill_step(
        params, {"tokens": t[:, :MESH_P],
                 "caches": bundle.make_cache(MESH_B, MESH_CACHE)})
    out = [full(logits)]
    for s in range(MESH_P, MESH_P + MESH_T):
        logits, caches = bundle.decode_step(params, {
            "token": t[:, s:s + 1],
            "pos": torch.full((MESH_B, 1), s, dtype=torch.int32),
            "caches": caches})
        out.append(full(logits))
    return out, sorted({type(c).__name__ for c in tree_leaves(caches)})


def mesh_serving(rank, world, cases):
    """Each case ``(arch, cfg_kw, shape, numpy params, tokens)``: serving
    logits unsharded and on a ``shape`` mesh of this group's ranks, the
    cache leaves' types after the last step, and ``serve.generate``'s
    ids and logits of 3 tokens, unsharded and on the mesh."""
    from repro_torch.sharding import mesh as meshes
    from repro_torch.launch.serve import generate
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo
    from repro_torch.params import from_numpy_tree
    from repro_torch.sharding import rules

    torch.set_num_threads(1)
    out = []
    for arch, cfg_kw, shape, np_params, toks, build_kw in cases:
        cfg = _mesh_cfg(arch, cfg_kw)
        params = from_numpy_tree(np_params, "cpu")
        _, axes = model_zoo.build(cfg, device="cpu").init(0)
        one = model_zoo.build(cfg, device="cpu", remat=False, **build_kw)
        mesh = meshes.make_host_mesh(shape, device="cpu")
        sh = model_zoo.build(cfg, shard=rules.make_shard_fn(mesh),
                             device="cpu", remat=False, **build_kw)
        placed = rules.distribute_params(params, axes, mesh)
        plain, _ = _serve(one, params, toks)
        real, seq = L._attention_seq_shards, []
        real_mla, mla = L._mla_attend_seq_shards, []

        def counted(*a, **kw):
            seq.append(1)
            return real(*a, **kw)

        def counted_mla(q_nope, *a, **kw):
            mla.append(q_nope.shape[1])          # the query's positions
            return real_mla(q_nope, *a, **kw)
        L._attention_seq_shards = counted
        L._mla_attend_seq_shards = counted_mla
        try:
            sharded, kinds = _serve(sh, placed, toks)
        finally:
            L._attention_seq_shards = real
            L._mla_attend_seq_shards = real_mla
        prompts = torch.from_numpy(toks[:, :MESH_P])
        gen = [generate(b, p, prompts, 3, MESH_CACHE)
               for b, p in ((one, params), (sh, placed))]
        out.append({"arch": arch, "cfg_kw": cfg_kw, "shape": shape,
                    "plain": plain, "seq_parallel": len(seq),
                    "mla_seq_parallel": mla, "layers": cfg.num_layers,
                    "sharded": sharded, "cache_types": kinds,
                    "generate": [(g.tokens.numpy(),
                                  [t.numpy() for t in g.logits])
                                 for g in gen]})
    return out


def _latents(tree):
    """The ``ckv`` and ``krope`` leaves of a cache tree."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in ([v] if k in ("ckv", "krope") else _latents(v))]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _latents(v)]
    return []


def mesh_mla_decode(rank, world, np_params, toks, cfg_kw):
    """deepseek-v2's smoke variant on (1, 2): a prefill of ``MESH_P``
    tokens, then one decode step under ``launch.roofline.StepCounter``:
    every collective the step issues (kind, the local input's shape and
    the bytes it sends) and, apart, the bytes by kind that the
    sequence-parallel MLA sends, with the cache blocks' local shapes."""
    from repro_torch.launch.roofline import StepCounter
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo
    from repro_torch.params import from_numpy_tree
    from repro_torch.sharding import mesh as meshes
    from repro_torch.sharding import rules

    torch.set_num_threads(1)
    cfg = _mesh_cfg("deepseek-v2-236b", cfg_kw)
    _, axes = model_zoo.build(cfg, device="cpu").init(0)
    mesh = meshes.make_host_mesh((1, 2), device="cpu")
    sh = model_zoo.build(cfg, shard=rules.make_shard_fn(mesh), device="cpu",
                         remat=False)
    placed = rules.distribute_params(from_numpy_tree(np_params, "cpu"), axes,
                                     mesh)
    t = torch.from_numpy(toks)
    _, caches = sh.prefill_step(placed, {
        "tokens": t[:, :MESH_P], "caches": sh.make_cache(MESH_B, MESH_CACHE)})
    blocks = sorted({tuple(c.to_local().shape[-3:])
                     for c in _latents(caches)})

    class Seen(StepCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.shape = tuple(args[0].shape) if args and isinstance(
                args[0], torch.Tensor) else None
            return super().__torch_dispatch__(func, types, args, kwargs)

        def add_collective(self, kind, n, *a, **kw):
            seen.append((kind, self.shape, n))
            super().add_collective(kind, n, *a, **kw)
    seen, inside = [], {}
    real = L._mla_attend_seq_shards

    def counted(*a, **kw):
        before = dict(counter.bytes_by_kind)
        out = real(*a, **kw)
        for k, v in counter.bytes_by_kind.items():
            inside[k] = inside.get(k, 0) + v - before.get(k, 0)
        return out
    L._mla_attend_seq_shards = counted
    try:
        with Seen(mesh) as counter:
            sh.decode_step(placed, {
                "token": t[:, MESH_P:MESH_P + 1],
                "pos": torch.full((MESH_B, 1), MESH_P, dtype=torch.int32),
                "caches": caches})
    finally:
        L._mla_attend_seq_shards = real
    return {"collectives": seen, "mla": inside, "cache_blocks": blocks,
            "total": counter.collectives()}


def mesh_placements(rank, world, archs):
    """``distribute_params`` on a (2, 2) mesh: each leaf's placements and
    local shape, beside ``spec_for``'s spec."""
    from repro_torch.sharding import mesh as meshes
    from repro_torch.models import transformer as PT
    from repro_torch.params import tree_leaves, tree_paths
    from repro_torch.sharding import rules

    mesh = meshes.make_host_mesh((2, 2), device="cpu")
    out = {}
    for arch in archs:
        cfg = _mesh_cfg(arch, {})
        params, axes = PT.init_model(cfg, torch.Generator().manual_seed(0))
        placed = rules.distribute_params(params, axes, mesh)
        out[arch] = [(rules.ShardingRules().spec_for(a, tuple(t.shape), mesh),
                      [("Shard", p.dim) if p.is_shard() else ("Replicate",)
                       for p in leaf.placements], tuple(leaf.shape),
                      tuple(leaf.to_local().shape))
                     for (_, a), t, leaf in zip(tree_paths(axes),
                                                tree_leaves(params),
                                                tree_leaves(placed))]
    return out


class KernelCalls:
    """Counts the calls of K1's and K2's wrappers where ``core.channels``
    reaches them (on the CPU a call is the plain version's, one a leaf
    table as a launch on the card), and each call's leaves' types."""

    def __enter__(self):
        from repro_torch.core import channels
        self.k1 = self.k2 = 0
        self.types = set()
        self._real = (channels.channel_norms_leaves,
                      channels.select_mask_leaves)
        real1, real2 = self._real

        def k1(gs, *a, **kw):
            self.k1 += 1
            self.types |= {type(g).__name__ for g in gs}
            return real1(gs, *a, **kw)

        def k2(leaves, *a, **kw):
            self.k2 += 1
            self.types |= {type(leaf[0]).__name__ for leaf in leaves}
            return real2(leaves, *a, **kw)
        channels.channel_norms_leaves, channels.select_mask_leaves = k1, k2
        return self

    def __exit__(self, *exc):
        from repro_torch.core import channels
        channels.channel_norms_leaves, channels.select_mask_leaves = \
            self._real


def _selection(grads, rate):
    """Channel scores, threshold, kept fraction and masked leaves of a
    slot-stacked gradient tree (plain, or DTensors), in numpy."""
    from repro_torch.core import channels
    from torch.distributed.tensor import DTensor

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()
    leaves, scores = channels.factored_scores_slots(grads)
    thr = channels.factored_threshold(scores, rate)
    masked, frac = channels.factored_mask_slots(leaves, scores, thr)
    return ([None if s is None else s.numpy() for s in scores], thr.numpy(),
            frac.numpy(), [full(m) for m in masked])


def _placed_like(grads, params):
    """One device's (K, ...) gradients placed as the DTensor params behind
    the client axis."""
    from repro_torch.params import tree_leaves, tree_unflatten
    from repro_torch.sharding import rules
    from torch.distributed.tensor import Shard
    return tree_unflatten(grads, [rules.distribute(
        g, p.device_mesh, [Shard(q.dim + 1) if isinstance(q, Shard) else q
                           for q in p.placements])
        for g, p in zip(tree_leaves(grads), tree_leaves(params))])


def mesh_federated(rank, world, shapes, arch, np_params, batch,
                   cfg_kw=None):
    """The federated step (K clients) unsharded and on each mesh shape,
    with the dense exchange and with the compressed one: losses and
    params; for the dense step the K1/K2 calls and its leaf tables, and
    the selection of this pod's clients' one-device gradients, whole and
    placed as the params (scores, threshold, fraction, masked values);
    for the compressed step ``_compressed_check``."""
    from repro_torch.comm import collectives
    from repro_torch.config import ScbfConfig
    from repro_torch.core import channels
    from repro_torch.core.distributed import (_local_clients,
                                              client_gradients,
                                              make_federated_train_step)
    from repro_torch.sharding import mesh as meshes
    from repro_torch.models import model_zoo
    from repro_torch.params import from_numpy_tree, tree_leaves
    from repro_torch.sharding import rules

    torch.set_num_threads(1)
    cfg = _mesh_cfg(arch, cfg_kw or {})
    params = from_numpy_tree(np_params, "cpu")
    _, axes = model_zoo.build(cfg, device="cpu").init(0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    one = model_zoo.build(cfg, device="cpu")
    scbf = ScbfConfig(upload_rate=0.10)
    packed = ScbfConfig(upload_rate=0.10, compressed_exchange=True)
    l1, p1 = make_federated_train_step(one.loss_fn, scbf, lr=0.05)(
        params, batch)
    lc, pc = make_federated_train_step(one.loss_fn, packed, lr=0.05)(
        params, batch)
    _, grads_all = client_gradients(one.loss_fn, params, batch)
    out = {"loss": float(l1),
           "params": [t.numpy() for t in tree_leaves(p1)],
           "compressed": {"loss": float(lc),
                          "params": [t.numpy() for t in tree_leaves(pc)]},
           "meshes": {}}
    for shape in shapes:
        mesh = meshes.make_host_mesh(shape, device="cpu")
        sh = model_zoo.build(cfg, shard=rules.make_shard_fn(mesh),
                             device="cpu")
        placed = rules.distribute_params(params, axes, mesh)
        # the selection on one device's gradients of this pod's clients,
        # whole and as shards
        _, grads = client_gradients(one.loss_fn, params,
                                    _local_clients(batch, mesh))
        plain = _selection(grads, scbf.upload_rate)
        split = _selection(_placed_like(grads, placed), scbf.upload_rate)
        leaves = tree_leaves(grads)
        tables = channels._score_tables(
            leaves, [i for i, t in enumerate(leaves) if t.ndim >= 3])
        collectives.reset_traffic()
        with KernelCalls() as calls:
            l2, p2 = make_federated_train_step(
                sh.loss_fn, scbf, lr=0.05, mesh=mesh)(placed, batch)
        dense_pod = _sent("pod")
        out["meshes"][shape] = {
            "loss": float(l2),
            "params": [t.full_tensor().numpy() for t in tree_leaves(p2)],
            "selection": (plain, split), "tables": len(tables),
            "k1": calls.k1, "k2": calls.k2,
            "kernel_inputs": sorted(calls.types),
            "traffic": {"pod": (collectives.calls, collectives.bytes_sent),
                        "mesh": collectives.traffic("mesh")},
            "compressed": _compressed_check(
                sh, placed, batch, packed, mesh, grads_all, grads,
                dense_pod)}
    return out


def _sent(family: str) -> int:
    """Bytes this rank sent over its links in one family's collectives
    since the counters were reset."""
    from repro_torch.comm import collectives
    return sum(v[2] for (f, _), v in collectives.by_kind.items()
               if f == family)


def _compressed_check(sh, placed, batch, packed, mesh, grads_all, grads,
                      dense_pod) -> dict:
    """The compressed step on ``mesh`` (loss, params, its K1/K2 calls and
    the bytes this rank sent over its links by family); the sharded
    ``_compressed_sum`` of this pod's clients' one-device gradients
    ``grads``, placed as the params, against the one-device sum of all
    the clients' ``grads_all`` (bitwise); the scores within 1e-6 of each
    client's k-th (``near``); and the pod bytes a rank sends counted by
    hand from ``grads_all``'s selection and the leaves' placements."""
    from repro_torch.comm import collectives
    from repro_torch.comm.collectives import link_bytes
    from repro_torch.core import channels
    from repro_torch.core.distributed import (_compressed_sum,
                                              _top_channels,
                                              make_federated_train_step)
    from repro_torch.params import tree_leaves
    from repro_torch.sharding import mesh as meshes
    from torch.distributed.tensor import DTensor

    rate = packed.upload_rate
    pods = mesh if meshes.num_pods(mesh) > 1 else None
    collectives.reset_traffic()
    with KernelCalls() as calls:
        loss, new = make_federated_train_step(
            sh.loss_fn, packed, lr=0.05, mesh=mesh)(placed, batch)
    sent = {f: _sent(f) for f in ("pod", "mesh")}
    want = tree_leaves(_compressed_sum(grads_all, rate))
    got = tree_leaves(_compressed_sum(_placed_like(grads, placed), rate,
                                      pods))
    got = [g.full_tensor() if isinstance(g, DTensor) else g for g in got]
    sums = [(w.ndim >= 2, bool(torch.equal(g, w)),
             float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)))
            for g, w in zip(got, want)]
    near = hand = 0
    P, K = meshes.num_pods(mesh), tree_leaves(grads_all)[0].shape[0]
    loss_bytes = link_bytes("all-reduce", 4, P)
    for g, p in zip(tree_leaves(_placed_like(grads_all, placed)),
                    tree_leaves(placed)):
        local = p.to_local()
        if g.ndim < 3:
            hand += link_bytes("all-reduce", local.numel() * 4, P)
            continue
        scores, idx = _top_channels(g, rate)
        k = idx.shape[1]
        kth = torch.topk(scores, k, axis=-1).values[:, -1:]
        near += int(torch.count_nonzero(
            (scores - kth).abs() <= 1e-6 * kth.abs())) - K
        ax = channels.shard_axes(g)
        rows = local.numel() // local.shape[-1]
        if ax.cols is None:        # every client's k channels
            hand += (P - 1) * (K // P) * k * (8 + 4 * rows)
            continue
        lo, hi = ax.col_start, ax.col_start + local.shape[-1]
        inside = ((idx >= lo) & (idx < hi)).reshape(P, -1)
        top = int(torch.count_nonzero(inside, axis=1).max())
        hand += (P - 1) * (8 + top * (8 + 4 * rows))
    return {"loss": float(loss),
            "params": [t.full_tensor().numpy() for t in tree_leaves(new)],
            "k1": calls.k1, "k2": calls.k2, "sent": sent,
            "sums": sums, "near": near,
            "pod_bytes": collectives.traffic("pod")[1],
            "pod_sent": sent["pod"], "hand_pod_sent":
                hand + loss_bytes if pods is not None else 0,
            "dense_pod_sent": dense_pod}


def mesh_experts(rank, world, np_layer, x, cfg_kw):
    """deepseek-v2's MoE layer on a (1, 2) mesh, experts split over
    ``model``: the routing tables (those of one device) and the output
    beside one device's, with ``moe_dshard`` off and on; and the experts
    each rank holds."""
    from repro_torch.sharding import mesh as meshes
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import ModelCtx
    from repro_torch.params import from_numpy_tree
    from repro_torch.sharding import rules

    torch.set_num_threads(1)
    cfg = _mesh_cfg("deepseek-v2-236b", cfg_kw)
    p = from_numpy_tree(np_layer, "cpu")
    _, axes = MOE.moe_init(torch.Generator().manual_seed(0), cfg,
                           torch.float32)
    mesh = meshes.make_host_mesh((1, 2), device="cpu")
    xt = torch.from_numpy(x)
    seen = []
    real = MOE._route

    def route(*a, **kw):
        got = real(*a, **kw)
        seen.append((got[0].numpy().copy(), got[1].detach().numpy().copy()))
        return got
    MOE._route = route
    try:
        plain = MOE.moe_apply(p, xt, ModelCtx(cfg=cfg, dtype=torch.float32))
        out = {"plain": plain.numpy(), "routes": [seen.pop()]}
        placed = rules.distribute_params(p, axes, mesh)
        out["experts_local"] = tuple(placed["wi"].to_local().shape)
        for dshard in (False, True):
            ctx = ModelCtx(cfg=cfg, dtype=torch.float32, moe_dshard=dshard,
                           shard=rules.make_shard_fn(mesh))
            from repro_torch.models.model_zoo import on_mesh
            with on_mesh(placed):
                y = MOE.moe_apply(
                    placed, rules.distribute(xt, mesh, rules.placements(
                        (None, None, None), mesh)), ctx)
            out[dshard] = y.full_tensor().numpy()
            out["routes"].append(seen.pop())
    finally:
        MOE._route = real
    return out


def mesh_jobs(rank, world, jobs):
    """Several rank bodies of this module in one group: ``jobs`` a list of
    (name, args); returns their results in order."""
    return [globals()[name](rank, world, *args) for name, args in jobs]
