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

    return Optimizer(init=init, update=update, name="adamw")


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
    def update(leaves, state, grads):
        step = state.step + 1
        stepf = step.float()
        lr_t = lr * torch.clamp(stepf / max(1, warmup_steps), max=1.0)
        rho = 1.0 - stepf ** (-decay)
        for name, leaf in leaves.items():
            p = _stacked(leaf)
            g = _stacked(grads[name]).float()
            nu = state.nu[name]
            g2 = g * g + eps
            if "row" in nu:
                nu["row"].copy_(rho * nu["row"]
                                + (1 - rho) * torch.mean(g2, dim=-1))
                nu["col"].copy_(rho * nu["col"]
                                + (1 - rho) * torch.mean(g2, dim=-2))
                rmean = torch.mean(nu["row"], dim=-1, keepdim=True)
                vhat = ((nu["row"] / torch.clamp(rmean, min=eps))[..., None]
                        * nu["col"][..., None, :])
            else:
                nu["full"].copy_(rho * nu["full"] + (1 - rho) * g2)
                vhat = nu["full"]
            u = g / torch.sqrt(torch.clamp(vhat, min=eps))
            # update clipping (RMS <= 1) over the whole leaf, as in the paper
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms, min=1.0)
            pf = p.float()
            new = (pf - lr_t * (u + weight_decay * pf)).to(p.dtype)
            if isinstance(leaf, tuple):
                for r, t in enumerate(leaf):
                    t.copy_(new[r])
            else:
                leaf.copy_(new)
        return leaves, OptState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update, name="adafactor")


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name}")
