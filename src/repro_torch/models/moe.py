"""Mixture-of-Experts FFN: top-k routing, per-expert capacity and the JAX
package's two dispatch semantics, in PyTorch's own idiom.

Port of the JAX package's ``models/moe.py``.  That layer is plain XLA (no
Pallas kernel), so plain torch ops stand in for it.  Semantics mirrored:

- routing in f32: softmax over the router logits, top-k of the
  probabilities, renormalised only when k > 1 (a top-1 weight stays the raw
  probability); the Switch aux loss E · Σ_e f_e · P_e, where f counts the
  first choice only;
- capacity C = max(4, ceil(n · k / E · capacity_factor));
- a (token, slot) entry's place in its expert's buffer is the number of
  earlier entries of its group routed to the same expert, token-major then
  slot; entries at places ≥ C are dropped and add nothing (the residual
  carries the token);
- ``moe_impl="einsum"`` (the default): G = max(1, N // 512) groups of
  T = N // G tokens, capacity C(T) per group.  The ragged tail N − G·T gets
  no routed output, and routing and aux cover only the first G·T tokens
  (ROADMAP F10, a fault of the reference that the port mirrors);
  ``"scatter"``: one group of all N tokens, capacity C(N).

Where the reference builds one-hot dispatch and combine tensors and
contracts them, the port counts places with a running sum over an (E,
entries) 0/1 tensor, puts tokens into one (E, G, C, d) buffer with
``index_put_`` (dropped entries go to one spare row that is never read) and
gathers the expert outputs back.  Every shape is fixed by (N, E, k, C) and
no value is read on the host, so the layer runs inside the captured paged
tick.  The expert products are three batched products over every expert
and every capacity slot, as the reference's are.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.sharded import on_shard, record_collective

from .config import ModelConfig
from .layers import dense_init, dtype_of
from .mlp import mlp, mlp_axes, mlp_init

# the reference's cfg_group_size: its configs set no moe_group_size
GROUP_SIZE = 512


# ==================================================================== params
def moe_init(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    """The router (d, E) in f32 whatever the model dtype, the experts'
    gated MLPs stacked on a leading E axis, and the shared experts as one
    gated MLP n_shared_experts · moe_d_ff wide.  The experts' fan-in is E,
    as the reference draws them (``dense_init`` on (E, d, ff) with its
    default ``in_axis=0``; ROADMAP F11)."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    p = {"router": dense_init(generator, (d, E), torch.float32, device),
         "w_gate": dense_init(generator, (E, d, ff), dt, device),
         "w_up": dense_init(generator, (E, d, ff), dt, device),
         "w_down": dense_init(generator, (E, ff, d), dt, device)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(generator, cfg, device,
                               d_ff=cfg.n_shared_experts * ff)
    return p


def moe_axes(cfg: ModelConfig) -> dict:
    p = {"router": ("embed", None),
         "w_gate": ("expert", "embed", "ffn"),
         "w_up": ("expert", "embed", "ffn"),
         "w_down": ("expert", "ffn", "embed")}
    if cfg.n_shared_experts:
        p["shared"] = mlp_axes()
    return p


# =================================================================== routing
def route(params, x_flat: torch.Tensor, cfg: ModelConfig):
    """x_flat (N, d) → (f32 weights (N, k), expert ids (N, k), f32 router
    probabilities (N, E), f32 one-hot first choices (N, E))."""
    probs = torch.softmax(x_flat.float() @ params["router"], dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.top_k > 1:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    first = torch.zeros_like(probs).scatter_(1, idx[:, :1], 1.0)
    return weights, idx, probs, first


def switch_aux(first: torch.Tensor, probs: torch.Tensor, n: int,
               cfg: ModelConfig) -> torch.Tensor:
    """The Switch aux loss of n routed tokens from their first-choice
    counts and probability sums (each (E,), summed over every row that
    holds some of them)."""
    return cfg.n_experts * torch.sum((first / n) * (probs / n))


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, c)


def groups(n_tokens: int, cfg: ModelConfig) -> tuple[int, int]:
    """(G, T): the dispatch's groups and their size."""
    if cfg.moe_impl == "scatter":
        return 1, n_tokens
    g = max(1, n_tokens // GROUP_SIZE)
    return g, n_tokens // g


class Span(NamedTuple):
    """Where one row's tokens lie among the tokens the dispatch groups (a
    batch split over a mesh's rows): the row's first token ``offset`` in
    token order (batch-major), the batch's ``total`` tokens, and ``carry``
    (G, E) int32, the entries each group gave each expert in the rows
    before (None: none before)."""
    offset: int
    total: int
    carry: torch.Tensor | None = None


class Dispatch(NamedTuple):
    """Where each (token, slot) entry of the routed tokens goes: the first
    G·T tokens of the batch, or a row's share of them."""
    weights: torch.Tensor   # (n, k) f32 combine weights
    row: torch.Tensor       # (n, k) row of the (E, groups, C) buffer, E·
    #                         groups·C if the entry is dropped
    keep: torch.Tensor      # (n, k) bool: the entry fits in its expert
    aux: torch.Tensor | None  # f32 scalar, the Switch aux loss (no span)
    groups: int             # the groups these tokens touch
    capacity: int
    # a row's share (a span): its first-choice counts (E,) and router
    # probability sums (E,), f32, and its entries per group and expert
    # (groups, E) int32 (dropped ones too); None without a span
    first: torch.Tensor | None = None
    probs: torch.Tensor | None = None
    counts: torch.Tensor | None = None
    group0: int = 0         # the batch's group of the first of them


def dispatch_plan(params, x_flat: torch.Tensor, cfg: ModelConfig,
                  span: Span | None = None) -> Dispatch:
    """Route x_flat (N, d) and place every entry in its expert's buffer.
    ``span``: x_flat is one row's tokens of a larger batch; its groups and
    capacity are the batch's, and an entry's place counts the entries of
    its group that the rows before gave its expert (``span.carry``)."""
    E, k = cfg.n_experts, cfg.top_k
    offset, total = (0, x_flat.shape[0]) if span is None else span[:2]
    G, T = groups(total, cfg)
    C = capacity(T, cfg)
    # the row's routed tokens: those before the ragged tail (F10)
    n = max(0, min(x_flat.shape[0], G * T - offset))
    weights, idx, probs, first = route(params, x_flat[:n], cfg)
    g0, g1 = offset // T, -(-(offset + n) // T)
    Gr, lead = g1 - g0, offset - g0 * T
    padded = bool(lead) or n < Gr * T
    expert = idx
    if padded:
        # pad to whole groups with entries of a spare expert E
        expert = idx.new_full((Gr * T, k), E)
        expert[lead:lead + n] = idx
    expert = expert.view(Gr, 1, T * k)
    # an entry's place: the entries of its group before it, token-major then
    # slot, that chose the same expert (an exclusive running count).  The
    # 0/1 tensor is (G, E, T·k), so the count runs along its innermost,
    # contiguous dimension: along an outer one, CUDA's scan walks the T·k
    # entries one after another
    hit = torch.zeros((Gr, E + int(padded), T * k), dtype=torch.int32,
                      device=x_flat.device)
    hit.scatter_(1, expert, 1)
    before = torch.cumsum(hit, dim=2, dtype=torch.int32) - hit
    place = before.gather(1, expert)[:, 0]                      # (Gr, T·k)
    ex = expert[:, 0].clamp(max=E - 1) if padded else expert[:, 0]
    share: dict = {}
    if span is None:
        aux = cfg.n_experts * torch.sum(first.mean(dim=0) * probs.mean(dim=0))
    else:
        aux = None
        share = dict(first=first.sum(dim=0), probs=probs.sum(dim=0),
                     counts=before[:, :E, -1] + hit[:, :E, -1], group0=g0)
        if span.carry is not None:
            place = place + span.carry[g0:g1].to(place.device).gather(1, ex)
    keep = place < C
    group = torch.arange(Gr, device=x_flat.device).view(Gr, 1)
    row = torch.where(keep, (ex * Gr + group) * C + place, E * Gr * C)
    sl = slice(lead * k, (lead + n) * k)
    return Dispatch(weights, row.view(-1)[sl].view(n, k),
                    keep.view(-1)[sl].view(n, k), aux, Gr, C, **share)


# ============================================================ expert compute
def _expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """xe (E, M, d) → (E, M, d): each expert's gated SiLU MLP over its M
    buffer rows, as three batched products."""
    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    return torch.bmm(F.silu(g) * u, params["w_down"])


def _dispatch(params, x_flat: torch.Tensor, cfg: ModelConfig,
              span: Span | None = None):
    """(the dispatch plan of x_flat (N, d), the (E, groups·C, d) buffer
    of its entries)."""
    d, E, k = x_flat.shape[1], cfg.n_experts, cfg.top_k
    plan = dispatch_plan(params, x_flat, cfg, span=span)
    n, rows = plan.row.shape[0], E * plan.groups * plan.capacity
    buf = x_flat.new_zeros((rows + 1, d))          # + the dropped entries' row
    buf.index_put_((plan.row,), x_flat[:n, None, :].expand(n, k, d))
    return plan, buf[:rows].view(E, -1, d)


def _combine(plan: Dispatch, ye: torch.Tensor, x_flat: torch.Tensor,
             partial: bool) -> torch.Tensor:
    """The routed output (N, d) from the experts' outputs ``ye`` (E·
    groups·C, d); ``partial``: the combine's f32 sum, before its
    rounding."""
    N, d = x_flat.shape
    n = plan.row.shape[0]
    # the reference contracts the k entries with combine weights cast to the
    # activation dtype, accumulating in f32 and rounding once
    w = plan.weights.to(x_flat.dtype).float()
    got = ye[torch.where(plan.keep, plan.row, 0)].float() * w[..., None]
    y = torch.where(plan.keep[..., None], got, 0.0).sum(dim=1)
    if not partial:
        y = y.to(x_flat.dtype)
    if n < N:                                      # the ragged tail (F10)
        y = torch.cat([y, y.new_zeros((N - n, d))])
    return y


def _routed(params, x_flat: torch.Tensor, cfg: ModelConfig, *,
            partial: bool = False):
    """The routed experts' output for x_flat (N, d), and the dispatch
    plan; ``partial``: the combine's f32 sum, before its rounding."""
    plan, xe = _dispatch(params, x_flat, cfg)
    ye = _expert_ffn(params, xe).view(-1, x_flat.shape[1])
    return _combine(plan, ye, x_flat, partial), plan


def group_span(offset: int, n: int, total: int,
               cfg: ModelConfig) -> tuple[int, int]:
    """[g0, g1): the dispatch groups that n tokens starting at ``offset``
    of a batch of ``total`` touch (``dispatch_plan``'s)."""
    G, T = groups(total, cfg)
    n = max(0, min(n, G * T - offset))
    return offset // T, -(-(offset + n) // T)


# ========================================================= experts over rows
class ExpertChain:
    """What the rows of one batch share when their MoE layers' experts lie
    over the mesh's rows ('data', Stage 5): for each MoE layer, the entries
    each (group, expert) has taken so far in token order (``carry``), and
    the routed tokens' first-choice counts and probability sums, added up
    in row order, from which ``aux`` forms the batch's Switch loss (it is
    not a sum of per-row losses)."""

    def __init__(self, cfg: ModelConfig, total: int):
        self.cfg, self.total = cfg, total
        self.carry: dict = {}
        self.first: dict = {}
        self.probs: dict = {}

    def aux(self, device) -> torch.Tensor:
        """The f32 sum over the MoE layers, in layer order, of each
        layer's aux loss over the batch's G·T routed tokens."""
        G, T = groups(self.total, self.cfg)
        out = torch.zeros((), dtype=torch.float32, device=device)
        for li in sorted(self.first):
            out = out + switch_aux(self.first[li].to(device),
                                   self.probs[li].to(device), G * T, self.cfg)
        return out


class Owner(NamedTuple):
    """A model shard of the row that holds one slice of the experts: its
    position in mesh order, and the (device, local param tree) that runs
    it (in the dry run the running row's own, standing in)."""
    index: int
    device: torch.device
    tree: dict


class RowExperts:
    """One row's view of experts that lie over the mesh's rows: where its
    tokens start among the batch's (``offset``), the chain it shares with
    the other rows, and ``owners``: for each slice of the experts, in
    expert order, the ``Owner`` of each model shard of the row that holds
    it.  ``stand_in``: (the row's first mesh position, (g0, g1)) where the
    dry run runs this row alone: the owner of the row's own slice then
    runs the groups [g0, g1) that every row sending to it touches, and the
    other slices are other devices' work.  A layer's carry is read once
    and its counts added to the chain once, so the recompute of a
    rematerialised layer places its entries as the first run did."""

    def __init__(self, chain: ExpertChain, offset: int, owners: list,
                 stride: int, stand_in: tuple | None = None):
        self.chain, self.offset, self.owners = chain, offset, owners
        self.stride = stride              # mesh positions between owners
        self.stand_in = stand_in
        self._carry: dict = {}
        self._done: set = set()

    def at(self, li: int, shard: int) -> "ExpertShard":
        return ExpertShard(self, li, shard)

    def carry_in(self, li: int):
        if li not in self._carry:
            carry = self.chain.carry.get(li)
            if carry is not None:
                record_collective("collective-permute",
                                  carry.numel() * carry.element_size(), 2,
                                  self.stride)
            self._carry[li] = carry
        return self._carry[li]

    def commit(self, li: int, plan: Dispatch) -> None:
        """Add the layer's counts and sums to the chain (once a layer)."""
        if li in self._done:
            return
        self._done.add(li)
        chain, E = self.chain, self.chain.cfg.n_experts
        G, _ = groups(chain.total, chain.cfg)
        carry = self._carry.get(li)
        dev = plan.counts.device
        add = torch.zeros((G, E), dtype=torch.int32, device=dev)
        add[plan.group0:plan.group0 + plan.groups] = plan.counts
        chain.carry[li] = add if carry is None else carry.to(dev) + add
        if li in chain.first:
            dev0 = chain.first[li].device
            chain.first[li] = chain.first[li] + plan.first.to(dev0)
            chain.probs[li] = chain.probs[li] + plan.probs.to(dev0)
        else:
            chain.first[li], chain.probs[li] = plan.first, plan.probs
        # the sums' all-reduce over the owners
        record_collective("all-reduce", 2 * E * 4, len(self.owners),
                          self.stride)


class ExpertShard(NamedTuple):
    """Model shard ``shard``'s view of layer ``li``'s experts over the
    rows (``RowExperts``)."""
    row: RowExperts
    li: int
    shard: int

    def span(self) -> Span:
        return Span(self.row.offset, self.row.chain.total,
                    self.row.carry_in(self.li))


def _filled(plan: Dispatch, E: int, device) -> torch.Tensor:
    """(E, groups, C) bool: the buffer slots an entry of ``plan`` holds."""
    n = E * plan.groups * plan.capacity
    hit = torch.zeros(n + 1, dtype=torch.bool, device=device)
    hit[plan.row] = True
    return hit[:n].view(E, plan.groups, plan.capacity)


def _owner_ffn(calls: list, plans: list) -> list:
    """Each call's expert outputs (E, groups·C, d) from its buffer: every
    owner device runs once over the slots that the calls of one chain
    send it (an all-to-all).  The calls of a chain hold disjoint slots of
    a group (each places its entries after those the calls before gave
    the expert), so the owner merges their slices of the buffer into one
    (E/rows, groups, C) buffer over the union of the groups they touch,
    runs one batched product over it, and sends each call the rows of its
    own groups back."""
    cfg = calls[0][2].row.chain.cfg
    E = cfg.n_experts
    jobs: dict = {}
    for k, (_, _, ex) in enumerate(calls):
        for o, shards in enumerate(ex.row.owners):
            jobs.setdefault((shards[ex.shard].index, id(ex.row.chain)),
                            []).append((k, o))
    outs = [[None] * len(ex.row.owners) for _, _, ex in calls]
    for (index, _), sends in jobs.items():
        k0, o = sends[0]
        ex0 = calls[k0][2]
        e = E // len(ex0.row.owners)
        owner = ex0.row.owners[o][ex0.shard]
        stand_in = ex0.row.stand_in
        if stand_in is not None and index != stand_in[0] + ex0.shard:
            # another owner's work, which the dry run does not run
            for k, o in sends:
                xe = plans[k][1]
                outs[k][o] = xe.new_empty((e,) + tuple(xe.shape[1:]))
            continue
        spans = [(plans[k][0].group0, plans[k][0].group0 + plans[k][0].groups)
                 for k, _ in sends] + ([stand_in[1]] if stand_in else [])
        lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
        C, d = plans[k0][0].capacity, plans[k0][1].shape[-1]
        with on_shard(ex0.shard):
            merged = plans[k0][1].new_zeros((e, hi - lo, C, d),
                                            device=owner.device)
            for k, o in sends:
                plan, xe = plans[k]
                g = slice(plan.group0 - lo, plan.group0 - lo + plan.groups)
                piece = xe[o * e:(o + 1) * e].view(e, plan.groups, C, d)
                mask = _filled(plan, E, xe.device)[o * e:(o + 1) * e]
                merged[:, g] = torch.where(
                    mask.to(owner.device, non_blocking=True)[..., None],
                    piece.to(owner.device, non_blocking=True), merged[:, g])
            y = _expert_ffn(owner.tree["layers"][ex0.li]["moe"],
                            merged.view(e, -1, d)).view(e, hi - lo, C, d)
            for k, o in sends:
                plan, xe = plans[k]
                g = slice(plan.group0 - lo, plan.group0 - lo + plan.groups)
                outs[k][o] = y[:, g].reshape(e, -1, d).to(
                    xe.device, non_blocking=True)
    yes = []
    for (_, _, ex), (_, xe), parts in zip(calls, plans, outs):
        ye = torch.cat(parts)
        if ex.shard == 0:
            n_owners = len(ex.row.owners)
            for t in (xe, ye):
                nbytes = t.numel() * t.element_size()
                record_collective("all-to-all", nbytes, n_owners,
                                  ex.row.stride)
                if t.requires_grad:
                    t.register_hook(lambda g, n=nbytes, o=n_owners, st=ex.row
                                    .stride: record_collective(
                                        "all-to-all", n, o, st))
        yes.append(ye)
    return yes


def moe_rows(calls: list, cfg: ModelConfig, *, partial: bool = False
             ) -> list:
    """``moe`` of each call (params, x, ``ExpertShard``), for MoE layers
    whose experts lie over the mesh's rows, the calls in the chains' token
    order (row by row, each row's shards in order): each routes its own
    tokens in the batch's groups and places each entry after the entries
    the calls before gave its expert; the owners run every chain's slots
    once (``_owner_ffn``); each call combines its outputs.  Returns each
    call's y (or, ``partial``, its parts); the aux is the chain's."""
    plans = []
    for params, x, ex in calls:
        with on_shard(ex.shard):
            plan, xe = _dispatch(params, x.reshape(-1, x.shape[-1]), cfg,
                                 span=ex.span())
        ex.row.commit(ex.li, plan)
        plans.append((plan, xe))
    yes = _owner_ffn(calls, plans)
    out = []
    for (params, x, ex), (plan, _), ye in zip(calls, plans, yes):
        with on_shard(ex.shard):
            y = _combine(plan, ye.view(-1, x.shape[-1]),
                         x.reshape(-1, x.shape[-1]), partial)
            out.append(_shared(params, x, y.view(x.shape), cfg, partial))
    return out


# ===================================================================== apply
def _shared(params: dict, x: torch.Tensor, y: torch.Tensor,
            cfg: ModelConfig, partial: bool):
    """The routed output y with the shared experts' MLP added after it
    (``partial``: the list of the unrounded f32 shares)."""
    if partial:
        parts = [y]
        if cfg.n_shared_experts:
            parts.append(mlp(params["shared"], x, partial=True))
        return parts
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x)
    return y


def moe(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
        partial: bool = False):
    """x (B, T, d), or the paged step's packed row (T, d) with its pad lanes
    (the reference routes them too) → (y of x's shape, f32 aux loss).  The
    shared experts' MLP is added after the routed part.

    ``partial``: the params are one tensor-parallel shard's ffn columns;
    y is then the list of its unrounded f32 shares, routed and shared,
    each summed over the shards and rounded before the two are added.
    Experts that lie over the mesh's rows run through ``moe_rows``."""
    y, plan = _routed(params, x.reshape(-1, x.shape[-1]), cfg,
                      partial=partial)
    return _shared(params, x, y.view(x.shape), cfg, partial), plan.aux
