"""Roofline terms of a sharded step on H100s (the counterpart of
``repro.launch.roofline``).

    compute term    = FLOPs_per_device / peak FLOP/s (bf16 on the tensor
                      cores for a bf16 model, else fp32)
    memory term     = bytes_per_device / HBM bandwidth
    collective term = bytes sent over NVLink / NVLink's rate each way
                      + bytes sent between nodes / NIC bandwidth

against ``config.HARDWARE``, the H100 table.  The reference reads its
terms from XLA's compiled module (``cost_analysis`` and the partitioned
HLO text, ``hlo_analysis.py``, which has no counterpart: the port runs
no compiler).  ``StepCounter`` takes their place: a dispatch mode that
sees the ops each rank runs on its local shards while a step executes
on DTensors (DTensor ops pass through to DTensor, whose local ops then
come back here), so its counts are per device:

* FLOPs: ``torch.utils.flop_counter``'s formulas on the local shapes
  (matrix products, convolutions, attention); elementwise ops count 0,
  as in XLA's own count;
* bytes: each local op's tensor inputs and outputs (views, aliases
  and allocations move nothing), the counterpart of XLA's "bytes
  accessed";
* collectives: the functional collectives DTensor issues when it
  redistributes, by kind, with the bytes each sends over the rank's
  links in a ring of the group's P ranks (``comm.collectives.link_bytes``:
  (P-1)/P of the whole tensor for an all-gather, a reduce-scatter or an
  all-to-all, 2(P-1)/P for an all-reduce), and those over a group of the
  mesh's ``pod`` axis, or spanning more than one node of
  ``gpus_per_node`` ranks, apart.  (The reference counts a collective's
  output shape.)  On a CPU mesh DTensor runs an all-to-all as an
  all-gather and a chunk; it counts as the all-to-all a card's mesh
  runs;
* memory, by device type: the bytes of each new storage an op creates,
  counted once when it is made and given back when it is freed (a weak
  reference to the storage, as ``torch.distributed._tools.mem_tracker``
  keeps); views, aliases and in-place results add nothing, and the
  state a step finds at entry is not counted.  ``peak_bytes[type]`` is
  the most held at once on that device type — XLA's
  ``temp_size_in_bytes`` counterpart, the step's rise above its state
  (the dry run reads ``"meta"``, a card ``"cuda"``: DTensor makes meta
  tensors for shapes on any device, which hold nothing there).  A
  kernel wrapper's plain version (what the wrappers run on the CPU and
  the meta device) counts as its outputs only: its temporaries are the
  plain version's, not the kernel's (``kernels.build.plain_version``).

DTensor's sharding propagation counts for nothing: not its storages,
FLOPs or bytes.  It derives an op's output metadata by running the op
under a ``FakeTensorMode`` on fake arguments it builds from the specs'
*global* shapes (``ShardingPropagator._propagate_tensor_meta_non_cached``
→ ``OpSchema.gen_fake_args`` → ``torch.empty_strided(global shape)``).
Those factory calls have no tensor input, and the fake mode runs them on
the meta device below this mode, so they arrive here as plain meta
storages of the global shape: a (128, 32768, 512) cache block where the
rank holds (8, 2048, 512).  ``__enter__`` therefore wraps that method
and every op run inside it is skipped, as is any op with a FakeTensor
input.  The method is wrapped rather than the mode stack read because a
mode is off the stack while it dispatches: when the fake mode hands an
op down, neither it nor this mode is on the stack to be seen.  Where
torch has no such method the counter raises rather than count as
before.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.comm.collectives import link_bytes
from repro_torch.config import HARDWARE, HardwareConfig

KINDS = {"all_gather_into_tensor": "all-gather",
         "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all",
         "broadcast": "broadcast"}


# ops that read and write no data: allocations, aliases, views
MOVES_NOTHING = frozenset({"empty", "empty_strided", "empty_like",
                           "new_empty", "new_empty_strided", "_unsafe_view",
                           "alias", "detach", "lift_fresh"})


def _tensors(tree, out: list) -> list:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order: ``out``, extended."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


# the method of DTensor's propagator that builds fake global-shape
# arguments and runs the op on them (torch 2.11 and 2.13)
PROPAGATE = "_propagate_tensor_meta_non_cached"


def _propagator():
    """The class whose ``PROPAGATE`` method the counter wraps; raises
    where this torch has none, rather than count its tensors."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if not callable(getattr(ShardingPropagator, PROPAGATE, None)):
        raise RuntimeError(
            f"torch {torch.__version__}: ShardingPropagator has no "
            f"{PROPAGATE}; StepCounter cannot leave DTensor's sharding "
            "propagation out of its counts")
    return ShardingPropagator


def _group_ranks(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(name))


class StepCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes, collectives and memory of the ops run
    while active (module docstring)."""

    def __init__(self, mesh=None, hw: HardwareConfig = HARDWARE):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.count_by_kind: Dict[str, int] = {}
        self.bytes_by_kind: Dict[str, int] = {}
        self.total_bytes = 0
        self.cross_pod_bytes = 0
        self.cross_node_bytes = 0
        self._node = hw.gpus_per_node
        self._pod = set()
        if mesh is not None and "pod" in (mesh.mesh_dim_names or ()):
            self._pod.add(mesh.get_group("pod").group_name)
        self._ranks: Dict[str, list] = {}
        self._alltoall = False
        self.live_bytes: Dict[str, int] = {}
        self.peak_bytes: Dict[str, int] = {}
        self._storages: Dict[int, weakref.ref] = {}
        self._plain = 0
        self._propagating = 0

    def _group(self, group: str) -> list:
        if group not in self._ranks:
            self._ranks[group] = _group_ranks(group)
        return self._ranks[group]

    def _crosses_nodes(self, group: str) -> bool:
        return len({r // self._node for r in self._group(group)}) > 1

    def __enter__(self):
        # DTensor's all-to-all, which a CPU mesh runs as an all-gather
        from torch.distributed.tensor import placement_types
        inner = self._inner = placement_types.shard_dim_alltoall

        def alltoall(*args, **kwargs):
            self._alltoall = True
            try:
                return inner(*args, **kwargs)
            finally:
                self._alltoall = False
        placement_types.shard_dim_alltoall = alltoall
        # DTensor's metadata pass, on fake tensors of the global shapes
        prop = _propagator()
        meta = self._meta_pass = getattr(prop, PROPAGATE)

        def propagate(*args, **kwargs):
            self._propagating += 1
            try:
                return meta(*args, **kwargs)
            finally:
                self._propagating -= 1
        setattr(prop, PROPAGATE, propagate)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor import placement_types
        placement_types.shard_dim_alltoall = self._inner
        setattr(_propagator(), PROPAGATE, self._meta_pass)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating:
            return out               # DTensor's sharding propagation
        tensors = _tensors(kwargs, _tensors(args, []))
        if any(isinstance(t, FakeTensor) for t in tensors):
            return out               # shapes only
        if not func.is_view:         # a view's storage is its input's
            self._hold(out, tensors)
        comm = func.namespace in ("_c10d_functional", "_dtensor")
        kind = KINDS.get(func._opname) if comm else None
        if kind is not None:
            group = args[-1]
            if self._alltoall:
                kind = "all-to-all"
            src = tensors[0]
            n = link_bytes(kind, src.numel() * src.element_size(),
                           len(self._group(group)))
            self.add_collective(kind, n, group in self._pod,
                                self._crosses_nodes(group))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not (comm or func.is_view or func._opname in MOVES_NOTHING):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors(out, tensors[:]))
        return out

    def _hold(self, out, inputs) -> None:
        """Count each storage of ``out`` that no input shares and that is
        not counted yet, until it is freed."""
        shared = None
        for t in _tensors(out, []):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            if shared is None:
                shared = {a.untyped_storage()._cdata for a in inputs}
            if key in shared:
                continue
            n, kind = st.nbytes(), st.device.type
            self._storages[key] = weakref.ref(
                st, functools.partial(self._freed, key, kind, n))
            self.live_bytes[kind] = self.live_bytes.get(kind, 0) + n
            if not self._plain:
                self._update_peak(kind)

    def _update_peak(self, kind: str) -> None:
        self.peak_bytes[kind] = max(self.peak_bytes.get(kind, 0),
                                    self.live_bytes[kind])

    def _freed(self, key: int, kind: str, n: int, _ref) -> None:
        del self._storages[key]
        self.live_bytes[kind] -= n

    @contextlib.contextmanager
    def plain_version(self):
        """A kernel wrapper's plain version: what it holds when it
        returns (its outputs) counts, its temporaries do not."""
        self._plain += 1
        try:
            yield
        finally:
            self._plain -= 1
            if not self._plain:
                for kind in self.live_bytes:
                    self._update_peak(kind)

    def add_collective(self, kind: str, n: int, cross_pod: bool,
                       cross_node: bool, calls: int = 1) -> None:
        """Count ``calls`` collectives that send ``n`` bytes in all over
        the rank's links (those issued outside DTensor too: the port's
        hand-written ones, ``comm.collectives``)."""
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + calls
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + n
        self.total_bytes += n
        self.cross_pod_bytes += n if cross_pod else 0
        self.cross_node_bytes += n if cross_node else 0

    def collectives(self) -> dict:
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "count_by_kind": dict(self.count_by_kind),
                "total_bytes": self.total_bytes,
                "cross_pod_bytes": self.cross_pod_bytes,
                "cross_node_bytes": self.cross_node_bytes}


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float,
                   hw: HardwareConfig = HARDWARE,
                   cross_node_bytes: float = 0.0,
                   dtype: str = "bfloat16") -> Dict[str, float]:
    """The three terms in seconds, the ``dominant`` one, and
    ``bound_fraction`` (the compute term over the largest), as the
    reference's.  Collective bytes are those a rank sends (while it
    receives as many): over NVLink at half its both-ways rate, except
    ``cross_node_bytes``, which go over the NIC (a one-way rate)."""
    peak = hw.peak_bf16 if dtype == "bfloat16" else hw.peak_fp32
    compute = flops_per_dev / peak
    memory = bytes_per_dev / hw.hbm_bw
    collective = (coll_bytes_per_dev - cross_node_bytes) \
        / (hw.nvlink_bw / 2) + cross_node_bytes / hw.nic_bw
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    total = max(compute, memory, collective)
    terms["bound_fraction"] = (compute / total) if total > 0 else 0.0
    return terms
