"""Mixture-of-Experts block with capacity-bucketed sort routing (port of
``repro.models.moe``).

Each token is routed to its top-k experts; an (experts, capacity) table
of token ids is built from a stable argsort over the expert assignments
(a token's position within its expert is its rank, found by
``searchsorted``); tokens are gathered into (E, C, D) expert buckets, the
SwiGLU experts run as batched products over the expert axis, and the
buckets are added back to token order, weighted by their router gates,
in one fp32 ``index_add``.  Tokens past an expert's capacity are dropped
(their residual path still carries them): they land in a scratch column
of the tables, which is cut off before any use.

With ``ctx.moe_groups`` = G > 1 the tokens are routed in G independent
groups, each with its own capacity (dropping is group-local), as in the
reference; on one device that is the same arithmetic batched over a
leading G axis.

On a ``(data, model)`` mesh (DTensor params, ``_experts_sharded``) the
experts split over ``model`` (expert parallel) and the groups over
``data`` where G divides it.  Routing (top-k, the stable argsort,
``searchsorted``, the tables' ``index_put``) has no DTensor strategy
over a split axis, so each rank routes its own groups whole, replicated
over ``model``, on its local tensors: the tables are those of one
device.  A rank then gathers the tokens of its own experts (no traffic),
runs them, and adds its buckets back to token order: a partial sum over
``model``, reduced where the sum is next read.  ``ctx.moe_dshard``
instead splits the dispatch and the combine over ``d_model``: every rank
gathers every expert's bucket of its own D slice, an all-to-all moves
the buckets to their experts' ranks and back, and the combine leaves
the output split over D, with no partial sum.  Either way the result is
one device's but for the order of the combine's sums.

DeepSeek-V2's router (``ArchConfig.router_*``): with
``router_expert_groups`` > 1 a token's top-k come from the
``router_topk_groups`` expert groups whose largest probability is
highest (group-limited greedy; the other groups' probabilities masked to
0), and with ``router_norm_topk`` off its gates are its probabilities,
not renormalised; either way they are scaled by ``router_scale``.

An expert share (``experts_held`` < ``num_experts``): the layer holds
experts ``[experts_offset, experts_offset + experts_held)``, routes each
token over all ``num_experts`` (the capacity too is reckoned from that
count) and builds dispatch tables for its own experts only; what the
experts held elsewhere would add is not computed, and nothing crosses.

Spans: ``moe.route`` (the router's product and softmax, the group limit,
top-k and the tables) and ``moe.experts`` (the held experts' gather,
products and combine); under remat both open again in the backward's
recompute.  ``slot_counts`` counts, while it is on, the routed slots
the held experts were given and those dropped past capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models.common import from_block, trunc_normal
from repro_torch.models.layers import ModelCtx, mlp_apply, mlp_init
from repro_torch.obs.trace import span


def moe_init(gen, cfg: ArchConfig, dtype):
    """(params, axes): the router (D, num_experts) in fp32 whatever
    ``dtype``, the held experts' ``wi``, ``wg`` (E_h, D, F) and ``wo``
    (E_h, F, D), and the shared expert (an MLP of ``d_ff *
    num_shared_experts``) when there is one."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    held = cfg.held_experts
    scale = 1.0 / (D ** 0.5)
    params = {
        "router": {"w": trunc_normal(gen, (D, E), scale, torch.float32)},
        "wi": trunc_normal(gen, (held, D, Fd), scale, dtype),
        "wg": trunc_normal(gen, (held, D, Fd), scale, dtype),
        "wo": trunc_normal(gen, (held, Fd, D), 1.0 / (Fd ** 0.5), dtype),
    }
    axes = {
        "router": {"w": "embed,none"},
        "wi": "experts,embed,mlp",
        "wg": "experts,embed,mlp",
        "wo": "experts,mlp,embed",
    }
    if cfg.num_shared_experts:
        params["shared"], axes["shared"] = mlp_init(
            gen, cfg, dtype, d_ff=cfg.d_ff * cfg.num_shared_experts)
    return params, axes


def _capacity(cfg: ArchConfig, num_tokens: int) -> int:
    c = int(cfg.moe_capacity_factor * num_tokens * cfg.experts_per_token
            / cfg.num_experts)
    c = max(c, 1)
    return ((c + 7) // 8) * 8        # 8-aligned buckets, as the reference


def _groups(ctx: ModelCtx, num_tokens: int) -> int:
    """The reference's group count: ``moe_groups`` lowered until it
    divides the tokens."""
    g = ctx.moe_groups
    while g > 1 and num_tokens % g:
        g -= 1
    return g


class SlotCounts:
    """The routed slots the held experts were given and those dropped
    past capacity, summed over the MoE layers' forward passes: two int64
    device tensors that ``_route`` adds to while ``on`` and nothing reads
    inside a step (``read`` synchronises).  A remat recompute in the
    backward adds nothing, so a step counts each forward once."""

    def __init__(self):
        self.on = False
        self.routed = self.dropped = None

    def add(self, routed: torch.Tensor, dropped: torch.Tensor) -> None:
        if routed.is_meta or torch._C._current_graph_task_id() != -1:
            return
        if self.routed is None or self.routed.device != routed.device:
            self.routed = torch.zeros((), dtype=torch.int64,
                                      device=routed.device)
            self.dropped = torch.zeros_like(self.routed)
        self.routed.add_(routed)
        self.dropped.add_(dropped)

    def read(self):
        """(routed, dropped) as ints (0, 0 before any count)."""
        if self.routed is None:
            return 0, 0
        return int(self.routed), int(self.dropped)

    def reset(self) -> None:
        self.routed = self.dropped = None


slot_counts = SlotCounts()


def _group_limited(probs: torch.Tensor, groups: int, top: int
                   ) -> torch.Tensor:
    """``probs`` (..., E) with every expert outside each token's ``top``
    groups (E / ``groups`` consecutive experts each, scored by their
    largest probability) set to 0."""
    g = probs.reshape(probs.shape[:-1] + (groups, probs.shape[-1] // groups))
    best = torch.topk(g.amax(-1), top, axis=-1).indices
    kept = torch.zeros(g.shape[:-1], dtype=torch.bool,
                       device=probs.device).scatter_(-1, best, True)
    return torch.where(kept[..., None], g, 0.0).reshape(probs.shape)


def _select(probs: torch.Tensor, k: int, cfg=None):
    """(gate, eidx) (..., k): each token's top-k experts (within its
    top groups where ``cfg`` limits them) and their gates, renormalised to
    sum to 1 unless ``cfg.router_norm_topk`` is off, then scaled by
    ``cfg.router_scale``."""
    scores = probs
    if cfg is not None and cfg.router_expert_groups > 1:
        scores = _group_limited(probs, cfg.router_expert_groups,
                                cfg.router_topk_groups)
    gate, eidx = torch.topk(scores, k, axis=-1)             # (G,Tg,k)
    if cfg is None or cfg.router_norm_topk:
        # the k gates summed left to right, as XLA sums so short a row (a
        # vectorised ``sum`` rounds another way), so the gates are bitwise
        total = gate[..., :1]
        for j in range(1, k):
            total = total + gate[..., j:j + 1]
        gate = gate / torch.clamp(total, min=1e-9)
    if cfg is not None and cfg.router_scale != 1.0:
        gate = gate * cfg.router_scale
    return gate, eidx


def _route(probs: torch.Tensor, k: int, capacity: int, cfg=None):
    """The dispatch tables of G groups of routed tokens.

    probs (G, Tg, E) fp32 router probabilities -> (table (G, E_h, C)
    int64 token ids, ``Tg`` for an empty slot; gate_tab (G, E_h, C) fp32
    gates, 0 for an empty slot), E_h the experts held (``cfg``'s share;
    all E without one).  Each token's top-k experts and gates come from
    ``_select``; a token's slot in an expert is its rank among the
    expert's tokens in token order (a stable sort); ranks past the
    capacity go to the scratch column ``C``, which is cut off, and the
    slots of experts held elsewhere to a scratch expert row, cut off too.
    Every write to a slot that is kept is the only one; the scratch
    slots' duplicates all write the same value (``Tg``, 0), so
    ``index_put`` without accumulation is deterministic.
    """
    G, Tg, E = probs.shape
    dev = probs.device
    gate, eidx = _select(probs, k, cfg)
    n = Tg * k
    flat_e = eidx.reshape(G, n)
    held, rows = E, E
    if cfg is not None and cfg.held_experts < E:
        held, rows = cfg.held_experts, cfg.held_experts + 1
        local = flat_e - cfg.experts_offset
        flat_e = torch.where((local >= 0) & (local < held), local,
                             torch.full_like(local, held))
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(k)[None] \
        .expand(G, n)
    flat_g = gate.reshape(G, n)
    order = torch.argsort(flat_e, axis=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(n, device=dev)[None] - first         # rank in expert
    keep = pos < capacity
    if rows > held:
        keep = keep & (sorted_e < held)
    if slot_counts.on:
        routed = torch.count_nonzero(sorted_e < held)
        slot_counts.add(routed, routed - torch.count_nonzero(keep))
    col = torch.where(keep, pos, torch.full_like(pos, capacity))
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, n)
    tok = torch.gather(flat_t, -1, order)
    table = torch.full((G, rows, capacity + 1), Tg, dtype=torch.int64,
                       device=dev).index_put(
        (g_idx, sorted_e, col), torch.where(keep, tok, torch.full_like(
            tok, Tg)))
    gates = torch.gather(flat_g, -1, order)
    gate_tab = torch.zeros((G, rows, capacity + 1), dtype=torch.float32,
                           device=dev).index_put(
        (g_idx, sorted_e, col), torch.where(keep, gates,
                                            torch.zeros_like(gates)))
    return table[:, :held, :capacity], gate_tab[:, :held, :capacity]


def _experts(p, xg: torch.Tensor, table: torch.Tensor,
             gate_tab: torch.Tensor) -> torch.Tensor:
    """xg (G, Tg, D) through the tables' buckets and the SwiGLU experts;
    the gate-weighted buckets added back to token order in fp32 (one
    ``index_add`` over the G·E·C bucket rows into G·(Tg + 1) rows, the
    pad rows cut off).  Returns (G, Tg, D) fp32."""
    G, Tg, D = xg.shape
    xpad = torch.cat([xg, torch.zeros((G, 1, D), dtype=xg.dtype,
                                      device=xg.device)], axis=1)
    g_idx = torch.arange(G, device=xg.device)[:, None, None]
    xe = xpad[g_idx, table]                                 # (G,E,C,D)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wi"])) * \
        torch.einsum("gecd,edf->gecf", xe, p["wg"])
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"])         # (G,E,C,D)
    yw = ye * gate_tab[..., None].to(ye.dtype)
    rows = (table + g_idx * (Tg + 1)).reshape(-1)
    yf = torch.zeros((G * (Tg + 1), D), dtype=torch.float32,
                     device=xg.device).index_add(
        0, rows, yw.reshape(-1, D).to(torch.float32))
    return yf.reshape(G, Tg + 1, D)[:, :Tg]


def _experts_sharded(p, xg, probs, k: int, capacity: int,
                     ctx: ModelCtx):
    """``_route`` and ``_experts`` over DTensors (module docstring): xg
    (G, Tg, D) and probs (G, Tg, E) DTensors; returns (G, Tg, D) fp32."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = xg.device_mesh
    G, Tg, D = xg.shape
    E = probs.shape[-1]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    # the groups split over data where they divide it; all else whole
    split_g = "data" in sizes and sizes["data"] > 1 and G % sizes["data"] == 0
    grp = [Shard(0) if split_g and n == "data" else Replicate()
           for n in mesh.mesh_dim_names]
    # the expert axis: where the experts' weights split their first dim
    ex = [i for i, q in enumerate(p["wi"].placements)
          if isinstance(q, Shard) and q.dim == 0] \
        if isinstance(p["wi"], DTensor) else []
    e_n = 1 if not ex else int(mesh.shape[ex[0]])
    e_l = E // e_n
    e_lo = 0 if not ex else mesh.get_local_rank(ex[0]) * e_l

    def over_experts(q, when):
        """``q``, or Partial on the expert axis."""
        return [Partial() if i in ex and when else g for i, g in
                enumerate(q)]

    if ctx.cfg.held_experts < E:
        raise ValueError("an expert share runs on one device: its layer "
                         "holds experts_held of num_experts")
    xg = ctx.shard(xg, ("group", "none", "none")).redistribute(mesh, grp)
    probs = probs.redistribute(mesh, grp)
    # a rank's routing gradient comes from its own experts' gates only
    table, gate_tab = _route(probs.to_local(
        grad_placements=over_experts(grp, True)), k, capacity, ctx.cfg)
    g_l = table.shape[0]
    g_idx = torch.arange(g_l, device=table.device)[:, None, None]
    if ctx.moe_dshard:
        # every expert's bucket of this rank's D slice, then an all-to-all
        # to the experts' ranks
        dsplit = [Shard(2) if i in ex else g for i, g in enumerate(grp)]
        xl = xg.redistribute(mesh, dsplit).to_local()
        xpad = torch.cat([xl, torch.zeros_like(xl[:, :1])], axis=1)
        xe = from_block(xpad[g_idx, table], mesh,
                        [Shard(3) if i in ex else g for i, g in enumerate(grp)],
                        (G, E, capacity, D))
    else:
        xl = xg.to_local(grad_placements=over_experts(grp, True))
        xpad = torch.cat([xl, torch.zeros_like(xl[:, :1])], axis=1)
        xe = from_block(xpad[g_idx, table[:, e_lo:e_lo + e_l]], mesh,
                        [Shard(1) if i in ex else g for i, g in enumerate(grp)],
                        (G, E, capacity, D))
    xe = ctx.shard(xe, ("group", "expert", "none", "none"))
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wi"])) * \
        torch.einsum("gecd,edf->gecf", xe, p["wg"])
    h = ctx.shard(h, ("group", "expert", "none", "none"))
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"])         # (G,E,C,D)
    gates = from_block(gate_tab[:, e_lo:e_lo + e_l], mesh,
                       [Shard(1) if i in ex else g for i, g in enumerate(grp)],
                       (G, E, capacity))
    yw = ye * gates[..., None].to(ye.dtype)
    if ctx.moe_dshard:
        yw = ctx.shard(yw, ("group", "none", "none", "mlp_act"))
        place = [Shard(3) if i in ex else g for i, g in enumerate(grp)]
        tab, out = table, [Shard(2) if i in ex else g
                           for i, g in enumerate(grp)]
    else:
        place = [Shard(1) if i in ex else g for i, g in enumerate(grp)]
        tab, out = table[:, e_lo:e_lo + e_l], over_experts(grp, True)
    ywl = yw.redistribute(mesh, place).to_local()
    rows = (tab + g_idx * (Tg + 1)).reshape(-1)
    yf = torch.zeros((g_l * (Tg + 1), ywl.shape[-1]), dtype=torch.float32,
                     device=ywl.device).index_add(
        0, rows, ywl.reshape(-1, ywl.shape[-1]).to(torch.float32))
    yf = from_block(yf.reshape(g_l, Tg + 1, -1)[:, :Tg], mesh, out,
                    (G, Tg, D))
    return ctx.shard(yf, ("group", "none", "none"))


def moe_apply(p, x: torch.Tensor, ctx: ModelCtx) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D): the routed experts plus the shared expert.

    The B·S tokens route as ``_groups`` groups (one unless
    ``ctx.moe_groups`` > 1), each at the capacity of its own tokens."""
    from torch.distributed.tensor import DTensor
    cfg = ctx.cfg
    B, S, D = x.shape
    T = B * S
    G = _groups(ctx, T)
    Tg = T // G
    xg = x.reshape(G, Tg, D)
    with span("moe.route"):
        logits = (xg.to(torch.float32) @ p["router"]["w"]).to(torch.float32)
        probs = torch.softmax(logits, axis=-1)              # (G,Tg,E)
        sharded = isinstance(xg, DTensor)
        if not sharded:
            table, gate_tab = _route(probs, cfg.experts_per_token,
                                     _capacity(cfg, Tg), cfg)
    with span("moe.experts"):
        if sharded:
            y = _experts_sharded(p, xg, probs, cfg.experts_per_token,
                                 _capacity(cfg, Tg), ctx)
        else:
            y = _experts(p, xg, table, gate_tab)
    y = y.reshape(B, S, D).to(x.dtype)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, ctx)
    return y


def aux_load_balance_loss(p, x: torch.Tensor, cfg: ArchConfig
                          ) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss: E · Σ_e (share of tokens
    whose first choice is e) · (mean router probability of e)."""
    D = x.shape[-1]
    logits = x.reshape(-1, D).to(torch.float32) @ p["router"]["w"]
    probs = torch.softmax(logits, -1)
    _, eidx = torch.topk(probs, cfg.experts_per_token, axis=-1)
    onehot = F.one_hot(eidx[..., 0], cfg.num_experts).to(torch.float32)
    frac_tokens = torch.mean(onehot, axis=0)
    frac_probs = torch.mean(probs, axis=0)
    return cfg.num_experts * torch.sum(frac_tokens * frac_probs)
