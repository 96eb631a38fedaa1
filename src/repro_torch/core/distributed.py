"""SCBF's federated train step over a param tree — the LM scenario (port
of ``repro.core.distributed``).

One federated train step is:

  1. each client computes its gradients on its own batch shard (the
     reference's ``vmap`` over a leading client axis is a loop over
     clients writing into preallocated ``(K, ...)`` buffers, so each
     leaf's K gradients are K slots of one tensor);
  2. each client's gradient tree is masked to its top-α output channels
     by *factored channel scores* (``core.channels``): one launch of the
     channel-norm kernel (K1) and one of the select-mask kernel (K2) a
     leaf table of every client — the paper's "Process Gradients" step;
  3. the server sums the masked gradients over the clients and takes the
     SGD step ``W <- W - lr · Σ_k ΔW̃_k``: one launch of the sum-and-step
     kernel (``kernels.sum_sgd``) a leaf, which reads each client's slot
     and the param once and writes the new param once.

The step holds one copy of the clients' gradients at a time: K2 writes
the masked values over them (``in_place``) and each leaf's client buffer
is dropped once its param is updated, so a step needs the params, the
(K, ...) buffers and one client's gradient tree (its peak, while
client_gradients copies it in).

With ``compressed_exchange`` each client's top-k channels by factored
score are gathered into an (α·rows)-sized buffer and the dense sum is
rebuilt by a scatter-add, plain torch as the reference's is plain
``jnp``.

Pods (the reference's ``spmd_axis_name="pod"``, here a ``mesh`` from
``sharding.mesh.make_pod_mesh``): the K clients split contiguously over the
P ranks, and each rank computes and masks its own clients' gradients (K1
and K2 once a leaf table a rank).  Only masked gradients or compact
buffers cross: the dense exchange all-reduces each rank's fp32 partial
sum of its masked clients (the reference's cross-pod all-reduce), rounded
once to the leaf's dtype after it; the compressed exchange all-gathers
the clients' ``(idx, vals)`` buffers in client order and rebuilds the
sum by the same scatter-add after the gather.  The mean loss is the sum
of the ranks' partial loss sums over K.

A ``(data, model)`` mesh (``(pod, data, model)`` with pods) shards each
client's computation: the params are DTensors on the pod's ``(data,
model)`` mesh (``sharding.rules.distribute_params``: FSDP over ``data``,
tensor and expert parallel over ``model``), a client's batch splits over
``data``, and each client's gradient comes out in its parameter's
placements.  The selection runs K1 and K2 on every rank's local shards
(``core.channels``), and the clients' sum and the update run shard by
shard; across pods each shard's fp32 partial sum is all-reduced with the
same shard of the other pods.

Spans (``obs.trace.span``, on a running profiler's timeline only):
``client_grad`` a client's gradient and its copy into the slot buffer,
``select`` the selection, ``sum_update`` the clients' sum and the update.

The compressed exchange on such a mesh ranks a leaf's channels as the
one-device step does, over the whole leaf: each rank's partial scores of
its shard are summed over the mesh axes that split the rows and gathered
over the one that splits the columns (``core.channels.shard_axes``), so
every rank of a pod holds the same ``(K, n)`` scores and takes the same
top-k, k from the whole width n.  A rank then reads the selected
channels that fall in its own columns from its shard and scatter-adds
them into its shard of the sum; across pods it exchanges those entries
only with the ranks that hold the same shard (``all_gather_compact``
where the columns are whole, ``all_gather_ragged`` where they split: the
count in a rank's columns depends on the data), in client order, so the
sum adds each column's clients in the one-device order.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.comm import collectives
from repro_torch.config import ScbfConfig
from repro_torch.core import channels
from repro_torch.sharding import mesh as meshes
from repro_torch.sharding.rules import like, local_shard
from repro_torch.models.common import from_block
from repro_torch.kernels.sum_sgd import sum_sgd
from repro_torch.models.model_zoo import value_and_grad
from repro_torch.obs.trace import span
from repro_torch.params import tree_leaves, tree_unflatten


def client_gradients(loss_fn: Callable, params, batch):
    """(losses (K,), gradient tree with every leaf (K, *leaf.shape)) of the
    K clients whose batches are the slots of ``batch``'s leaves (K, ...).
    Client k's gradient is written into slot k of one buffer a leaf, in
    the leaf's dtype, and let go before client k + 1's backward; params
    are left without ``requires_grad``."""
    k_clients = next(iter(batch.values())).shape[0]
    leaves = tree_leaves(params)
    grads = [torch.empty((k_clients,) + tuple(local_shard(p).shape),
                         dtype=p.dtype, device=p.device) for p in leaves]
    losses = []
    for k in range(k_clients):
        with span("client_grad"):
            loss, g = value_and_grad(loss_fn, params,
                                     {name: v[k] for name, v in batch.items()})
            g = tree_leaves(g)
            for i, buf in enumerate(grads):
                buf[k].copy_(local_shard(g[i]))
            del g               # gone before the next client's backward
        losses.append(loss)
    return torch.stack(losses), tree_unflatten(params, [
        _stacked(buf, p) for buf, p in zip(grads, leaves)])


def _unstacked(local: torch.Tensor, leaf):
    """A local shard of one of a (K, ...) leaf's slots (a client's, or
    the clients' sum) placed as the leaf's param: ``_stacked``'s
    inverse."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(leaf, DTensor):
        return local
    return from_block(local, leaf.device_mesh,
                      [Shard(q.dim - 1) if isinstance(q, Shard) else q
                       for q in leaf.placements], tuple(leaf.shape[1:]))


def _stacked(buf: torch.Tensor, p):
    """A (K, ...) buffer of a param's local gradients as the leaf the
    selection takes: a DTensor with the param's placements behind the
    client axis when the param is one."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(p, DTensor):
        return buf
    return from_block(buf, p.device_mesh,
                      [Shard(q.dim + 1) if isinstance(q, Shard) else q
                       for q in p.placements],
                      (buf.shape[0],) + tuple(p.shape))


def make_federated_train_step(loss_fn: Callable, scbf: ScbfConfig,
                              lr: float = 1e-3, mesh=None) -> Callable:
    """Returns step(params, batch) -> (mean_loss, new_params).

    ``batch`` leaves carry a leading client axis (K, ...).  ``mesh``: a
    mesh with a pod axis of P ranks (a pod mesh, or ``(pod, data,
    model)``); rank r's pod then takes clients ``[r·K/P, (r+1)·K/P)`` of
    the batch every rank is given (``K % P`` must be 0).  A mesh with a
    ``data`` or ``model`` axis above 1 takes params that are DTensors on
    its ``(data, model)`` mesh and a ``loss_fn`` of a bundle built with
    its ``make_shard_fn``.
    """
    pods = mesh if mesh is not None and meshes.num_pods(mesh) > 1 else None

    def step(params, batch):
        if pods is not None:
            batch = _local_clients(batch, pods)
        losses, grads_k = client_gradients(loss_fn, params, batch)
        loss = torch.mean(losses) if pods is None else \
            collectives.all_reduce_sum(torch.sum(losses, axis=0), pods) / (
                losses.shape[0] * meshes.num_pods(pods))
        if scbf.compressed_exchange:
            summed = tree_leaves(_compressed_sum(grads_k, scbf.upload_rate,
                                                 pods))
            del grads_k
            return loss, _sum_and_update(params, summed, lr)
        with span("select"):
            masked_k, _ = channels.apply_factored_mask_slots(
                grads_k, scbf.upload_rate, scbf.selection, in_place=True)
        del grads_k
        leaves = tree_leaves(masked_k)
        del masked_k
        with span("sum_update"):
            return loss, _sum_and_update(params, leaves, lr, pods)

    return step


def _local_clients(batch: dict, mesh) -> dict:
    """This rank's contiguous block of the batch's K clients."""
    k_clients = next(iter(batch.values())).shape[0]
    p = meshes.num_pods(mesh)
    if k_clients % p:
        raise ValueError(f"{k_clients} clients do not split over {p} pods")
    per = k_clients // p
    r = meshes.pod_rank(mesh)
    return {name: v[r * per:(r + 1) * per] for name, v in batch.items()}


def _sum_and_update(params, slots: list, lr: float, mesh=None):
    """``sgd_update(params, Σ_k slots_k, lr)`` leaf by leaf, one launch
    of the sum-and-step kernel a leaf on the card (``kernels.sum_sgd``),
    each buffer of ``slots`` (the list's only reference) let go once its
    param is updated.  A leaf's buffer is the clients' (K, ...) masked
    gradients, or a sum already made (the compressed exchange's), shaped
    as its param and taken as one slot.  On pods each rank's fp32
    partial sum is all-reduced and rounded once to the leaf dtype, then
    taken as one slot.  A DTensor param is summed and updated shard by
    shard."""
    new = []
    for i, p in enumerate(tree_leaves(params)):
        local = local_shard(slots[i]).contiguous()
        slots[i] = None
        if mesh is not None:
            local = collectives.all_reduce_sum(torch.sum(
                local, axis=0, dtype=torch.float32), mesh).to(p.dtype)
        p_local = local_shard(p).contiguous()
        if local.ndim == p_local.ndim:
            local = local[None]
        new.append(like(sum_sgd(p_local, local, lr), p))
    return tree_unflatten(params, new)


def _compressed_sum(grads_k, rate: float, mesh=None):
    """Σ_k of top-α-channel compressed client gradients, each sum placed
    as its leaf's param (a DTensor leaf's sum is computed on its local
    shard; module docstring).

    Every leaf carries a leading client axis (K, ..., n).  Per client the
    top-k output channels by factored score are taken and only their
    entries exchanged — on pods all-gathered in client order; the dense
    sum is reassembled by one scatter-add over the stacked entries
    (``index_add_`` sums clients that selected the same channel).  A
    vector leaf (always uploaded) is summed densely, on pods as an
    all-reduced fp32 partial sum.
    """
    out = []
    for leaf in tree_leaves(grads_k):
        local = local_shard(leaf)
        if leaf.ndim - 1 < 2:
            if mesh is None:
                summed = torch.sum(local, axis=0)
            else:
                summed = collectives.all_reduce_sum(torch.sum(
                    local, axis=0, dtype=torch.float32), mesh)
        else:
            summed = _channel_sum(leaf, rate, mesh)
        out.append(_unstacked(summed.to(leaf.dtype), leaf))
    return tree_unflatten(grads_k, out)


def _channel_sum(leaf, rate: float, mesh=None) -> torch.Tensor:
    """The fp32 sum over the K clients of a (K, ..., n) leaf's top-k
    channels, on its local shard: each client's whole ``k`` channels
    where the leaf's columns are whole, else the selected entries in
    this rank's columns, client by client."""
    _, idx = _top_channels(leaf, rate)
    local = local_shard(leaf)
    ax = channels.shard_axes(leaf)
    if ax is None or ax.cols is None:
        K, k = idx.shape
        idx_b = idx.reshape((K,) + (1,) * (local.ndim - 2) + (k,))
        vals = torch.gather(local, -1, idx_b.expand(
            local.shape[:-1] + (k,))).to(torch.float32)
        if mesh is not None:
            idx, vals = collectives.all_gather_compact(idx, vals, mesh)
        return _scatter_sum(idx, vals, local.shape[-1])
    cols, vals = _in_columns(local, idx, ax.col_start, leaf.shape[-1])
    if mesh is not None:
        cols, vals = collectives.all_gather_ragged(cols, vals, mesh)
    dense = torch.zeros(local.shape[1:], dtype=torch.float32,
                        device=local.device)
    dense.index_add_(dense.ndim - 1, cols, vals)
    return dense


def _top_channels(leaf, rate: float):
    """The fp32 channel scores (K, n) of a (K, ..., n) leaf — a DTensor's
    partial scores of its shard summed and gathered over the mesh — and
    each client's top-k channels by them, idx (K, k) with k from the
    whole width n."""
    local = local_shard(leaf)
    lf = local.to(torch.float32)
    scores = torch.sum(lf * lf, axis=tuple(range(1, local.ndim - 1)))
    del lf
    ax = channels.shard_axes(leaf)
    if ax is not None:
        scores = collectives.shard_gather(
            collectives.shard_sum(scores, ax.mesh, ax.rows), ax.mesh,
            () if ax.cols is None else (ax.cols,))
    k = max(1, int(rate * leaf.shape[-1]))
    return scores, torch.topk(scores, k, axis=-1).indices


def _in_columns(local: torch.Tensor, idx: torch.Tensor, start: int, n: int):
    """The selected channels ``idx`` (K, k) of K clients that fall in the
    columns [start, start + n_local) of a local shard (K, ..., n_local):
    (local column (m,), fp32 values (..., m)), client by client, each
    client's in ``idx``'s order.  On the meta device (the dry run, which
    has no scores to read) each client's entries are the expected share,
    ceil(k · n_local / n)."""
    K, k = idx.shape
    n_local = local.shape[-1]
    if local.is_meta:
        m = K * -(-k * n_local // n)
        return (torch.empty((m,), dtype=idx.dtype, device="meta"),
                torch.empty(local.shape[1:-1] + (m,), dtype=torch.float32,
                            device="meta"))
    inside = (idx >= start) & (idx < start + n_local)
    client = torch.arange(K, device=idx.device)[:, None].expand(K, k)[inside]
    cols = idx[inside] - start
    return cols, torch.movedim(local, 0, -2)[..., client, cols].to(
        torch.float32)


def _scatter_sum(idx: torch.Tensor, vals: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """The fp32 (..., n) sum of K clients' compact buffers (idx (K, k),
    vals (K, ..., k)): one ``index_add_`` over the stacked (K·k)
    entries."""
    K, k = idx.shape
    flat_vals = torch.movedim(vals, 0, -2).reshape(
        vals.shape[1:-1] + (K * k,))
    dense = torch.zeros(vals.shape[1:-1] + (n,), dtype=torch.float32,
                        device=vals.device)
    dense.index_add_(dense.ndim - 1, idx.reshape(K * k), flat_vals)
    return dense


def _compressed_masked(grads, rate: float):
    """Top-k channel gather/scatter of one client's gradient tree: zeros
    outside the top-α channels like the dense mask, with the values
    carried as an (α·rows) buffer — top_k and gather before, scatter
    after.  The same selected set as ``apply_factored_mask`` when no
    scores tie."""
    leaves, scores = channels.factored_scores(grads)
    out = []
    for leaf, s in zip(leaves, scores):
        if s is None:
            out.append(leaf)
            continue
        k = max(1, int(rate * s.shape[0]))
        idx = torch.topk(s, k).indices                     # (k,) channels
        vals = torch.index_select(leaf, leaf.ndim - 1, idx)  # (..., k)
        out.append(_scatter_last(torch.zeros_like(leaf), idx, vals))
    return tree_unflatten(grads, out)


def _scatter_last(dense, idx, vals):
    """Scatter vals (..., k) into dense (..., n) at last-axis idx (k,)."""
    out = dense.clone()
    out[..., idx] = vals
    return out


def client_batch_shape(global_batch: int, num_clients: int, seq: int
                       ) -> Tuple[int, int, int]:
    if global_batch % num_clients:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{num_clients} clients")
    return (num_clients, global_batch // num_clients, seq)
