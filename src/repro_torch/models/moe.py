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
    """x_flat (N, d) → (f32 weights (N, k), expert ids (N, k), f32 aux)."""
    probs = torch.softmax(x_flat.float() @ params["router"], dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.top_k > 1:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    first = torch.zeros_like(probs).scatter_(1, idx[:, :1], 1.0)
    aux = cfg.n_experts * torch.sum(first.mean(dim=0) * probs.mean(dim=0))
    return weights, idx, aux


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, c)


def groups(n_tokens: int, cfg: ModelConfig) -> tuple[int, int]:
    """(G, T): the dispatch's groups and their size."""
    if cfg.moe_impl == "scatter":
        return 1, n_tokens
    g = max(1, n_tokens // GROUP_SIZE)
    return g, n_tokens // g


class Dispatch(NamedTuple):
    """Where each (token, slot) entry of the first G·T tokens goes."""
    weights: torch.Tensor   # (G·T, k) f32 combine weights
    row: torch.Tensor       # (G·T, k) row of the (E, G, C) buffer, E·G·C if
    #                         the entry is dropped
    keep: torch.Tensor      # (G·T, k) bool: the entry fits in its expert
    aux: torch.Tensor       # f32 scalar, the Switch aux loss
    groups: int
    capacity: int


def dispatch_plan(params, x_flat: torch.Tensor, cfg: ModelConfig) -> Dispatch:
    """Route x_flat (N, d) and place every entry in its expert's buffer."""
    E, k = cfg.n_experts, cfg.top_k
    G, T = groups(x_flat.shape[0], cfg)
    C = capacity(T, cfg)
    weights, idx, aux = route(params, x_flat[:G * T], cfg)
    expert = idx.view(G, 1, T * k)
    # an entry's place: the entries of its group before it, token-major then
    # slot, that chose the same expert (an exclusive running count).  The
    # 0/1 tensor is (G, E, T·k), so the count runs along its innermost,
    # contiguous dimension: along an outer one, CUDA's scan walks the T·k
    # entries one after another
    hit = torch.zeros((G, E, T * k), dtype=torch.int32, device=x_flat.device)
    hit.scatter_(1, expert, 1)
    before = torch.cumsum(hit, dim=2, dtype=torch.int32) - hit
    place = before.gather(1, expert)[:, 0]                      # (G, T·k)
    keep = place < C
    group = torch.arange(G, device=x_flat.device).view(G, 1)
    row = torch.where(keep, (expert[:, 0] * G + group) * C + place,
                      E * G * C)
    return Dispatch(weights, row.view(G * T, k), keep.view(G * T, k), aux,
                    G, C)


# ============================================================ expert compute
def _expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """xe (E, M, d) → (E, M, d): each expert's gated SiLU MLP over its M
    buffer rows, as three batched products."""
    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    return torch.bmm(F.silu(g) * u, params["w_down"])


def _routed(params, x_flat: torch.Tensor, cfg: ModelConfig, *,
            partial: bool = False):
    """The routed experts' output for x_flat (N, d), and the aux loss;
    ``partial``: the combine's f32 sum, before its rounding."""
    N, d = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    plan = dispatch_plan(params, x_flat, cfg)
    n, rows = plan.row.shape[0], E * plan.groups * plan.capacity
    buf = x_flat.new_zeros((rows + 1, d))          # + the dropped entries' row
    buf.index_put_((plan.row,), x_flat[:n, None, :].expand(n, k, d))
    ye = _expert_ffn(params, buf[:rows].view(E, -1, d)).view(rows, d)
    # the reference contracts the k entries with combine weights cast to the
    # activation dtype, accumulating in f32 and rounding once
    w = plan.weights.to(x_flat.dtype).float()
    got = ye[torch.where(plan.keep, plan.row, 0)].float() * w[..., None]
    y = torch.where(plan.keep[..., None], got, 0.0).sum(dim=1)
    if not partial:
        y = y.to(x_flat.dtype)
    if n < N:                                      # the ragged tail (F10)
        y = torch.cat([y, y.new_zeros((N - n, d))])
    return y, plan.aux


# ===================================================================== apply
def moe(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
        partial: bool = False):
    """x (B, T, d), or the paged step's packed row (T, d) with its pad lanes
    (the reference routes them too) → (y of x's shape, f32 aux loss).  The
    shared experts' MLP is added after the routed part.

    ``partial``: the params are one tensor-parallel shard's ffn columns;
    y is then the list of its unrounded f32 shares, routed and shared,
    each summed over the shards and rounded before the two are added."""
    y, aux = _routed(params, x.reshape(-1, x.shape[-1]), cfg,
                     partial=partial)
    y = y.view(x.shape)
    if partial:
        parts = [y]
        if cfg.n_shared_experts:
            parts.append(mlp(params["shared"], x, partial=True))
        return parts, aux
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x)
    return y, aux
