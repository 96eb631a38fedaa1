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
and keep-masks are ``Replicate``.  Executing the zoo on a ``(data,
model)`` mesh from these specs (FSDP, tensor and expert parallel) is
ROADMAP A15b: ``make_shard_fn`` is the identity where those axes are 1
and refuses the rest.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import split_ax
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


def make_shard_fn(mesh, batch_shardable: bool = True,
                  group_axes=None, batch_override=None):
    """The ``ctx.shard`` callback of model code under ``mesh``: the
    identity where the mesh's ``data`` and ``model`` axes are 1 (nothing
    to lay out on one device a pod).  Larger axes need the zoo's FSDP,
    tensor and expert parallel execution: ROADMAP A15b."""
    sizes = axis_sizes(mesh)
    if sizes.get("data", 1) != 1 or sizes.get("model", 1) != 1:
        raise NotImplementedError(
            f"sharded execution over mesh axes {sizes} is ROADMAP A15b; "
            "not ported yet")
    activation_rules(mesh, batch_shardable, group_axes, batch_override)

    def shard(x: torch.Tensor, logical) -> torch.Tensor:
        return x
    return shard
