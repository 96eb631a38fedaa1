"""Logical-axis -> mesh-axis sharding rules (port of
``repro.sharding.rules``); pure host code.

Params carry logical axis names (``models.common``).  ``spec_for`` maps
them to mesh axes with the reference's priorities and divisibility
fall-through:

  * ``model`` (tensor parallel): experts first, then fused head/kv
    projections, FFN intermediates, vocab, SSM inner dim — the FIRST
    divisible candidate on each tensor wins;
  * ``data`` (FSDP): the remaining largest divisible dim, preferring
    ``embed``;
  * ``pod``: NEVER used for weights — it is the federated/client axis:
    weights are replicated across pods and only the channel-masked
    gradient exchange crosses it.

A spec is a tuple with the entries of the reference's ``PartitionSpec``
(a mesh axis name, a tuple of names, or None a dimension).  The
federated placements are ``torch.distributed`` placements on the 1-D pod
mesh: a round's slot axis is ``Shard`` — contiguous rank ranges
``[r·B/P, (r+1)·B/P)`` (``slot_range``) — and weights
and keep-masks are ``Replicate``.

The zoo executes on a ``(data, model)`` mesh from these specs (FSDP,
tensor and expert parallel): ``distribute_params`` makes every param a
``DTensor`` with ``param_placements``' ``Shard``/``Replicate`` a mesh
axis, ``place_inputs`` places a batch and its caches by ``input_specs``
(the reference's ``dryrun._input_shardings`` and
``_cache_in_shardings``), and ``make_shard_fn``'s callback redistributes
an activation to ``activation_spec``'s placements at the model's shard
points.  DTensor propagates the placements through every other op, as
GSPMD does from the reference's specs: the math is the one-device math.
On a mesh with ``pod`` the model lives on this rank's ``(data, model)``
submesh (``model_mesh``): weights never split over pods, and a pod takes
its own clients (or batch rows).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import from_block, split_ax
from repro_torch.params import tree_map

# priority order of logical axes for the 'model' mesh axis
MODEL_PRIORITY = ("experts", "heads", "kv", "mlp", "inner", "vocab",
                  "lora", "state")
# priority order for the 'data' (FSDP) mesh axis
DATA_PRIORITY = ("embed", "mlp", "vocab", "heads", "inner")
# never sharded
FROZEN = ("layers", "conv", "none")


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its dim names and shape) or
    of any mesh whose ``shape`` is already that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


@dataclass(frozen=True)
class ShardingRules:
    mesh_model: str = "model"
    mesh_data: str = "data"
    fsdp: bool = True                # shard weights over data axis too

    def spec_for(self, axes: str, shape: Tuple[int, ...], mesh) -> tuple:
        names = split_ax(axes)
        if len(names) != len(shape):
            raise ValueError(f"axes {axes!r} do not match shape {shape}")
        sizes = axis_sizes(mesh)
        model_n = sizes[self.mesh_model]
        data_n = sizes[self.mesh_data]
        assign: list = [None] * len(shape)

        def place(mesh_axis: str, n: int, priority) -> Optional[int]:
            for logical in priority:
                for i, nm in enumerate(names):
                    if nm == logical and assign[i] is None \
                            and shape[i] % n == 0 and shape[i] >= n:
                        assign[i] = mesh_axis
                        return i
            return None

        place(self.mesh_model, model_n, MODEL_PRIORITY)
        if self.fsdp:
            place(self.mesh_data, data_n, DATA_PRIORITY)
        return tuple(assign)


def param_shardings(axes_tree, mesh, rules: ShardingRules = ShardingRules(),
                    shapes_tree=None):
    """The spec tree of params given their logical-axes tree and a tree of
    tensors (or anything with ``.shape``, the meta device's too) of the
    same structure, for the divisibility checks."""
    return tree_map(lambda axes, leaf: rules.spec_for(
        axes, tuple(leaf.shape), mesh), axes_tree, shapes_tree)


# ---------------------------------------------------------------------------
# Federated cohorts
# ---------------------------------------------------------------------------

def _need_pod(mesh) -> None:
    if "pod" not in _axis_names(mesh):
        raise ValueError(f"mesh {_axis_names(mesh)} has no 'pod' axis")


def cohort_shardings(mesh):
    """(slot placement, replicated) for a bucketed participant cohort:
    per-participant arrays split their leading slot axis over ``pod``;
    the global model is replicated — weights never shard over pod."""
    from torch.distributed.tensor import Replicate, Shard
    _need_pod(mesh)
    return Shard(0), Replicate()


def keep_mask_sharding(mesh):
    """SCBFwP neuron keep-masks: replicated, like weights (model-geometry
    state every slot shares, never split on the client axis)."""
    from torch.distributed.tensor import Replicate
    _need_pod(mesh)
    return Replicate()


def fused_plan_shardings(mesh):
    """(round-slot placement, replicated) for fused ``(S, B, …)`` plans:
    the round axis S (axis 0) never splits, each round's slot axis B
    (axis 1) splits over ``pod``; the carried model is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    _need_pod(mesh)
    return Shard(1), Replicate()


def slot_range(num_slots: int, mesh) -> Tuple[int, int]:
    """This rank's contiguous slots ``[r·B/P, (r+1)·B/P)`` of a round of
    ``num_slots`` (a multiple of the pod count)."""
    p = axis_sizes(mesh)["pod"]
    if num_slots % p:
        raise ValueError(f"{num_slots} slots do not split over {p} pods")
    per = num_slots // p
    r = mesh.get_local_rank("pod")
    return r * per, (r + 1) * per


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


def activation_rules(mesh, batch_shardable: bool = True,
                     group_axes=None, batch_override=None
                     ) -> Dict[str, object]:
    """logical activation axis -> mesh axes (the reference's table)."""
    b = (batch_axes(mesh) if batch_shardable else ()) \
        if batch_override is None else tuple(batch_override)
    g = b if group_axes is None else tuple(group_axes)
    return {
        "batch": b,
        "group": g,
        "kv_seq": ("model",),
        "vocab_act": ("model",),
        "mlp_act": ("model",),
        "expert": ("model",),
        "capacity": (),          # bucket capacity: keep with expert shard
        "heads_act": (),
        "none": (),
    }


def activation_spec(logical: Sequence[str], rules: Dict[str, object]
                    ) -> tuple:
    out = []
    for name in logical:
        ax = rules.get(name, ())
        out.append(tuple(ax) if ax else None)
    return tuple(out)


def batch_spec(mesh, batch_size: int) -> tuple:
    """Spec for the leading batch dim of inputs; falls back to replication
    when the batch doesn't divide (long_500k has batch 1)."""
    axes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    n = int(np.prod([sizes[a] for a in axes]))
    if batch_size % n == 0:
        return (axes,)
    if batch_size % sizes[axes[-1]] == 0:
        return (axes[-1],)
    return (None,)


def model_mesh(mesh):
    """The mesh the model's tensors live on: ``mesh`` itself, or this
    rank's ``(data, model)`` submesh of a mesh with ``pod``."""
    if "pod" in _axis_names(mesh):
        return mesh["data", "model"]
    return mesh


def placements(spec: Sequence, mesh) -> list:
    """A spec's DTensor placements on ``mesh``: one a mesh axis, ``Shard(d)``
    where the spec names that axis at tensor dimension d (an entry that
    names several axes splits d over them, the first outermost) and the
    axis is above 1, else ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    names, sizes = _axis_names(mesh), axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            if sizes[a] > 1:       # a split in one part replicates
                out[names.index(a)] = Shard(d)
    return out


def divisible_spec(spec: Sequence, shape: Sequence[int], mesh) -> tuple:
    """``spec`` with every entry whose axes do not divide its dimension
    replaced by None (the reference's divisibility guard)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, spec):
        n = 1 if ax is None else int(np.prod(
            [sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
        out.append(ax if ax is not None and dim % n == 0 and dim >= n
                   else None)
    return tuple(out)


def param_placements(axes_tree, mesh, rules: ShardingRules = ShardingRules(),
                     shapes_tree=None):
    """The tree of DTensor placements of params on ``model_mesh(mesh)``,
    from ``spec_for`` (``param_shardings``' specs)."""
    mm = model_mesh(mesh)
    return tree_map(lambda axes, leaf: placements(rules.spec_for(
        axes, tuple(leaf.shape), mm), mm), axes_tree, shapes_tree)


def distribute(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``t`` (the same on every rank) as a DTensor on ``mesh`` with
    ``place``: each rank keeps its own slice, nothing is sent.  The
    tensor must already live on the mesh's device type (DTensor would
    move it there), or on the meta device (the dry run: a meta shard of
    the local shape on any mesh)."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if t.is_meta:                  # shapes only: a meta shard, no data
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh,
                                                         place)
        return from_block(torch.empty(local, dtype=t.dtype, device="meta"),
                          mesh, place, t.shape)
    if t.device.type != mesh.device_type:
        raise ValueError(f"a {t.device.type} tensor on a "
                         f"{mesh.device_type} mesh: build the mesh for the "
                         "tensors' device")
    return distribute_tensor(t, mesh, place, src_data_rank=None)


def distribute_params(params, axes_tree, mesh,
                      rules: ShardingRules = ShardingRules()):
    """Every param leaf as a DTensor on ``model_mesh(mesh)``, placed by
    ``param_placements`` (FSDP over ``data``, tensor/expert parallel over
    ``model``)."""
    mm = model_mesh(mesh)
    place = param_placements(axes_tree, mesh, rules, params)
    return tree_map(lambda t, pl: distribute(t, mm, pl), params, place)


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def like(local: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``local`` (a shard of ``t``'s local shape, or a view of one) as a
    DTensor placed as ``t``; ``local`` shaped as ``t`` when ``t`` is
    plain."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return local.view(t.shape)
    return from_block(local.view(t.to_local().shape), t.device_mesh,
                      t.placements, t.shape)


# ---------------------------------------------------------------------------
# Inputs and caches (the reference's dryrun._input_shardings and
# _cache_in_shardings)
# ---------------------------------------------------------------------------

def _cache_spec(path: Sequence[str], ndim: int, bspec) -> tuple:
    stacked = "stack" in path
    leaf = path[-1]
    lead = (None,) if stacked else ()
    if leaf in ("k", "v"):
        return lead + (bspec, "model", None, None)
    if leaf in ("k_scale", "v_scale", "ckv", "krope"):
        return lead + (bspec, "model", None)
    if leaf == "kpos":
        return lead + (bspec, "model")
    if leaf == "h":
        return lead + (bspec, "model", None, None)
    if leaf == "conv":
        return lead + (bspec, None, "model")
    if leaf == "ctx_tokens":
        return (bspec, None, None)
    return (None,) * ndim


def input_specs(batch, mesh, federated: bool = False) -> object:
    """The spec tree of a batch (the reference's ``_input_shardings``):
    token ids, positions and context embeddings split their batch over
    the batch axes (over ``data`` behind a leading client axis,
    ``federated``), caches go by ``cache_specs``, the rest replicates.
    On ``model_mesh(mesh)``: a pod's rows or clients are its own."""
    mm = model_mesh(mesh)
    ids = batch["tokens"] if "tokens" in batch else batch["token"]
    b = "data" if federated else batch_spec(mm, ids.shape[0])[0]
    lead = (None,) if federated else ()

    def leaf(path, t):
        name = path[-1]
        if path[0] == "caches":
            s = _cache_spec(path, t.ndim, b)
        elif name in ("tokens", "targets", "token", "pos"):
            s = lead + (b, None)
        elif name in ("audio_embeds", "image_embeds"):
            s = lead + (b, None, None)
        else:
            s = (None,) * t.ndim
        return divisible_spec(s, t.shape, mm)
    return _path_map(leaf, batch)


def place_inputs(batch, mesh, federated: bool = False):
    """A batch of plain tensors (the same on every rank) as DTensors on
    ``model_mesh(mesh)`` by ``input_specs``; DTensors (caches a previous
    step returned) stay as they are."""
    from torch.distributed.tensor import DTensor
    mm = model_mesh(mesh)
    specs = input_specs(batch, mesh, federated)
    return _zip_map(lambda t, spec: t if isinstance(t, DTensor) else
                    distribute(t, mm, placements(spec, mm)), batch, specs)


def _path_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _path_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_path_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


# ---------------------------------------------------------------------------
# The model's shard points
# ---------------------------------------------------------------------------

def make_shard_fn(mesh, batch_shardable: bool = True,
                  group_axes=None, batch_override=None):
    """The ``ctx.shard`` callback of model code under ``mesh``: it
    redistributes a DTensor activation to ``activation_spec``'s
    placements on ``model_mesh(mesh)`` (entries that do not divide
    dropped), as the reference's ``with_sharding_constraint``; a plain
    tensor, and every tensor on a mesh whose ``data`` and ``model`` axes
    are 1, pass through.  The callback carries the mesh as ``.mesh``
    (None where it places nothing)."""
    from repro_torch.sharding.mesh import is_sharded
    mm = model_mesh(mesh) if hasattr(mesh, "mesh_dim_names") else mesh
    if not hasattr(mesh, "mesh_dim_names") or not is_sharded(mm):
        def shard(x: torch.Tensor, logical) -> torch.Tensor:
            return x
        shard.mesh = None
        return shard
    def no_pod(axes):
        return None if axes is None else tuple(a for a in axes if a != "pod")
    rules = activation_rules(mm, batch_shardable, no_pod(group_axes),
                             no_pod(batch_override))

    def shard(x: torch.Tensor, logical) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        spec = divisible_spec(activation_spec(logical, rules), x.shape, mm)
        want = placements(spec, mm)
        return x if list(x.placements) == want else \
            x.redistribute(mm, want)
    shard.mesh = mm
    return shard
