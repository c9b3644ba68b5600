"""The training step: CE loss, microbatch grad accumulation, clipping.

Port of the JAX package's ``training/train.py``.  ``make_train_step(cfg,
opt)`` returns ``train_step(state, batch) -> (state, metrics)``: the loss
and its gradients through ``models.forward(mode="train")`` (K2 and K3 on
the card, their plain versions' gradients; each pattern copy recomputed in
the backward when ``cfg.remat``, as the reference's scan body is), the
gradients' global norm clipped to ``max_grad_norm``, then the optimizer's
in-place update (``optimizer.py``).  The step reads nothing back to the
host: metrics are device scalars.

The loss materialises the (B, S, V) f32 logits once, as the reference's
does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models import (forward, init_params, params_from_numpy,
                                stacked_leaves)
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _to_torch

from repro_torch.tree import named_leaves, tree_leaves, tree_map

from .optimizer import Optimizer, OptState, clip_by_global_norm


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits (B,S,V) f32; targets (B,S) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets.long()[..., None],
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        logits, aux = forward(params, batch["inputs"], batch["positions"],
                              cfg, mode="train")
        ce = cross_entropy(logits.float(), batch["targets"],
                           batch.get("mask"))
        loss = ce + cfg.router_aux_coef * aux
        return loss, {"ce": ce, "aux_loss": aux}
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``, as ``jax.value_and_grad(..., has_aux=True)`` gives them:
    grads in the params' layout and dtypes.
    The params are differentiated through detached views, so the caller's
    tensors never require grad."""
    views = tree_map(lambda t: t.detach().requires_grad_(), params)
    flat = tree_leaves(views)
    with torch.enable_grad():
        loss, metrics = loss_fn(views, batch)
        # a leaf the loss never reads (an embeds config's untied lookup
        # table) gets zeros, as in the JAX package
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    it = iter(grads)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(it), views))


def make_train_step(cfg: ModelConfig, opt: Optimizer, *,
                    grad_accum: int = 1, max_grad_norm: float = 1.0):
    loss_fn = make_loss_fn(cfg)

    def train_step(state: TrainState, batch):
        if grad_accum > 1:
            # microbatch over the leading batch axis; grads summed in f32
            def split(x, i):
                b = x.shape[0] // grad_accum
                return x[i * b:(i + 1) * b]

            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.opt_state.step.device)
            for i in range(grad_accum):
                mb = {k: split(v, i) for k, v in batch.items()}
                (l_i, metrics), g_i = value_and_grad(loss_fn, state.params,
                                                      mb)
                grads = tree_map(torch.add, grads, g_i)
                loss = loss + l_i
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
        else:
            (loss, metrics), grads = value_and_grad(loss_fn, state.params,
                                                     batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        _, new_opt = opt.update(stacked_leaves(state.params, cfg),
                                state.opt_state,
                                stacked_leaves(grads, cfg))
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       step=new_opt.step)
        return TrainState(state.params, new_opt), metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt: Optimizer,
                     generator: torch.Generator | None = None,
                     device="cuda") -> TrainState:
    params = init_params(cfg, generator, device=device)
    return TrainState(params=params,
                      opt_state=opt.init(stacked_leaves(params, cfg)))


def clone_state(state: TrainState) -> TrainState:
    """A copy of every tensor of ``state``: a step updates its state in
    place, so a caller that needs the state before a step keeps a clone."""
    return tree_map(torch.clone, state)


# ===================================================== numpy <-> the port
def train_state_from_numpy(tree, cfg: ModelConfig, device="cuda"
                           ) -> TrainState:
    """The port's ``TrainState`` from a JAX ``TrainState`` (params,
    ``OptState(step, mu, nu)``) after ``jax.tree.map(np.asarray, ...)``.
    AdamW's moments (a tree shaped as the params) become f32 tensors per
    leaf, a stacked leaf's split into its layers; Adafactor's factored
    statistics stay stacked, one per JAX leaf."""
    params_np, (step, mu, nu) = tree
    params = params_from_numpy(params_np, cfg, device)
    names = list(stacked_leaves(params, cfg))
    conv = lambda a: _to_torch(a, device)

    def per_leaf(moments):
        flat = dict(named_leaves(moments))
        return {n: (tuple(conv(a) for a in flat[n])
                    if n.startswith("segments/") else conv(flat[n]))
                for n in names}

    if isinstance(nu["final_norm"]["scale"], dict):          # adafactor
        stats = {}
        for n, a in named_leaves(nu):
            leaf, stat = n.rsplit("/", 1)
            stats.setdefault(leaf, {})[stat] = conv(a)
        opt = OptState(step=conv(np.asarray(step, np.int32)),
                       mu={n: conv(a) for n, a in named_leaves(mu)},
                       nu={n: stats[n] for n in names})
    else:
        opt = OptState(step=conv(np.asarray(step, np.int32)),
                       mu=per_leaf(mu), nu=per_leaf(nu))
    return TrainState(params, opt)
