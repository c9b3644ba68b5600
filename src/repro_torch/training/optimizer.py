"""Optimizers over the params' leaves (no torch.optim dependency).

Port of the JAX package's ``training/optimizer.py``, same update rules and
dtypes:

- ``adamw``     — moments in f32, params updated in their own dtype (no f32
                  master copy), weight decay on every leaf;
- ``adafactor`` — factored second moment (row/col statistics) for every
                  leaf of two or more dims, no momentum, each update
                  clipped to RMS <= 1 over its whole leaf.

An optimizer works on the JAX package's leaves: ``models.stacked_leaves``
gives, by the JAX leaf name, either the port's tensor or, for a leaf the
JAX package stacks on a segment's ``repeat`` axis (one per segment and
pattern position, shape ``(repeat, ...)``), the tuple of the port's
per-layer tensors.  AdamW is elementwise and treats every tensor alone.
Adafactor decides factoring and clips on the stacked leaf, as the
reference does: a per-layer norm scale (d,) is a factored (repeat, d) leaf
there, its column statistic a mean over the layers, its clip over all of
them.

``update`` writes the new params and moments INTO the given tensors (under
``torch.no_grad``) and returns them with a new ``OptState``: the port's
counterpart of donating the state to a jitted step.  It keeps one copy of
the training state on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.sharded import record_collective
from repro_torch.tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the params' device
    mu: Any              # {leaf name: first moment} (adamw) / zero scalars
    nu: Any              # {leaf name: second moment} (adamw) / factored stats


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], OptState]
    update: Callable[[dict, OptState, dict], tuple[dict, OptState]]
    name: str = "opt"
    # the update over one or more rows of shards, in lockstep
    # (``launch.spmd``): (each shard's leaves, OptState and grads; each
    # leaf's split dim over 'model' or None; ...) -> each shard's new
    # OptState (see ``adafactor``'s ``update_shards``)
    update_shards: Callable | None = None


def _mean(ts: list, dim: int, split: bool, group: int) -> list:
    """Each shard's mean of its tensor over ``dim``; ``split``: the dim is
    split over the ``group`` shards (the given ones, or the first of them
    in the dry run), so the local sums are added in shard order (an
    all-reduce) and divided by the whole dim."""
    if not split:
        return [torch.mean(t, dim=dim) for t in ts]
    sums = [torch.sum(t, dim=dim) for t in ts]
    total = sums[0]
    for t in sums[1:]:
        total = total + t.to(total.device)
    record_collective("all-reduce", total.numel() * 4, group)
    n = ts[0].shape[dim] * group
    return [(total / n).to(t.device) for t in ts]


def _each(update):
    """``update_shards`` of an elementwise optimizer: every shard alone."""
    def update_shards(leaves, states, grads, splits, group=None, **_):
        return [update(lv, st, g)[1] for lv, st, g in zip(leaves, states,
                                                         grads)]
    return update_shards


def _global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global f32 norm is at most ``max_norm``,
    each in its own dtype; the norm before clipping)."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _step_zero(leaves) -> torch.Tensor:
    device = tree_leaves(leaves)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          warmup_steps: int = 100) -> Optimizer:
    def init(leaves):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(step=_step_zero(leaves), mu=tree_map(zeros, leaves),
                        nu=tree_map(zeros, leaves))

    @torch.no_grad()
    def update(leaves, state, grads):
        step = state.step + 1
        # the reference's schedule reads the incremented step plus one
        lr_t = lr * torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        for name, p_leaf in leaves.items():
            for p, g, m, v in zip(*map(tree_leaves, (
                    p_leaf, grads[name], state.mu[name], state.nu[name]))):
                g = g.float()
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g * g)
                pf = p.float()
                upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                    + weight_decay * pf
                p.copy_(pf - lr_t * upd)
        return leaves, OptState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update, name="adamw",
                     update_shards=_each(update))


def _stacked(leaf) -> torch.Tensor:
    """A leaf as the JAX package holds it: a tuple of per-layer tensors
    stacked on a leading repeat axis."""
    return torch.stack(leaf) if isinstance(leaf, tuple) else leaf


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              weight_decay: float = 0.0, warmup_steps: int = 100) -> Optimizer:
    """Factored 2nd-moment Adafactor (no momentum): O(rows+cols) state for
    matrices.  Factoring and the update clip are decided on the stacked
    leaf (see the module note)."""

    def shape_of(leaf) -> tuple:
        return ((len(leaf),) + tuple(leaf[0].shape) if isinstance(leaf, tuple)
                else tuple(leaf.shape))

    def init(leaves):
        device = tree_leaves(leaves)[0].device
        f32 = dict(dtype=torch.float32, device=device)
        nu = {}
        for name, leaf in leaves.items():
            shape = shape_of(leaf)
            nu[name] = ({"row": torch.zeros(shape[:-1], **f32),
                         "col": torch.zeros(shape[:-2] + shape[-1:], **f32)}
                        if len(shape) >= 2
                        else {"full": torch.zeros(shape, **f32)})
        return OptState(step=_step_zero(leaves),
                        mu={name: torch.zeros((), **f32) for name in leaves},
                        nu=nu)

    @torch.no_grad()
    def update_shards(leaves, states, grads, splits, group=None, rows=1,
                      spread=None, row_group=None):
        """The leaves of ``rows`` rows of shards (row-major, one slice of
        shards each) in lockstep: a statistic over a dim a row's shards
        split (``splits[name]``: the stacked leaf's split dim over 'model',
        or None) is the mean over the whole dim, its shards' sums added in
        shard order; over a dim the rows split (``spread[name]``, for a
        leaf split over the rows too: the experts over 'data', params under
        fsdp) likewise over the rows, shard by shard.  The update clip's
        RMS is over the whole leaf: over every shard and row that hold a
        piece of it.  ``group``: a row's shard count, and ``row_group``:
        the rows a copy of a spread leaf spans, when only the first of them
        are given (the dry run)."""
        step = states[0].step + 1
        stepf = step.float()
        lr_t = lr * torch.clamp(stepf / max(1, warmup_steps), max=1.0)
        rho = 1.0 - stepf ** (-decay)
        per = len(leaves) // rows
        n = group or per
        nr = row_group or rows
        spread = spread or {}
        by_row = lambda ts, fn: [y for q in range(rows)
                                 for y in fn(ts[q * per:(q + 1) * per])]

        def by_col(ts, fn):
            out = [None] * len(ts)
            for s in range(per):
                for q, y in zip(range(rows), fn(ts[s::per])):
                    out[q * per + s] = y
            return out

        for name in leaves[0]:
            split = splits.get(name)
            rsplit = spread.get(name)
            ps = [_stacked(lv[name]) for lv in leaves]
            gs = [_stacked(g[name]).float() for g in grads]
            nus = [st.nu[name] for st in states]
            nd = gs[0].dim()
            g2 = [g * g + eps for g in gs]

            def means(ts, dim, on):
                if rsplit == on:
                    return by_col(ts, lambda t: _mean(t, dim, True, nr))
                return by_row(ts, lambda t: _mean(t, dim, split == on, n))

            if "row" in nus[0]:
                r_stat = means(g2, -1, nd - 1)
                c_stat = means(g2, -2, nd - 2)
                for nu, r, c in zip(nus, r_stat, c_stat):
                    nu["row"].copy_(rho * nu["row"] + (1 - rho) * r)
                    nu["col"].copy_(rho * nu["col"] + (1 - rho) * c)
                rmeans = means([nu["row"] for nu in nus], -1, nd - 2)
                vhats = [((nu["row"] / torch.clamp(rm[..., None], min=eps))
                          [..., None] * nu["col"][..., None, :])
                         for nu, rm in zip(nus, rmeans)]
            else:
                for nu, q in zip(nus, g2):
                    nu["full"].copy_(rho * nu["full"] + (1 - rho) * q)
                vhats = [nu["full"] for nu in nus]
            us = [g / torch.sqrt(torch.clamp(v, min=eps))
                  for g, v in zip(gs, vhats)]
            # update clipping (RMS <= 1) over the whole leaf
            sqs = [(u * u).reshape(-1) for u in us]
            if rsplit is not None and split is not None and n > 1:
                sq = _mean(sqs, 0, True, n * nr)
            elif rsplit is not None:
                sq = by_col(sqs, lambda t: _mean(t, 0, True, nr))
            else:
                sq = by_row(sqs, lambda t: _mean(
                    t, 0, split is not None and n > 1, n))
            for lv, p, u, q in zip(leaves, ps, us, sq):
                u = u / torch.clamp(torch.sqrt(q + 1e-12), min=1.0)
                pf = p.float()
                new = (pf - lr_t * (u + weight_decay * pf)).to(p.dtype)
                leaf = lv[name]
                if isinstance(leaf, tuple):
                    for r, t in enumerate(leaf):
                        t.copy_(new[r])
                else:
                    leaf.copy_(new)
        return [OptState(step=step.to(st.step.device), mu=st.mu, nu=st.nu)
                for st in states]

    @torch.no_grad()
    def update(leaves, state, grads):
        return leaves, update_shards([leaves], [state], [grads], {})[0]

    return Optimizer(init=init, update=update, name="adafactor",
                     update_shards=update_shards)



def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name}")
