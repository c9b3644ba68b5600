"""The training step: CE loss, microbatch grad accumulation, clipping.

Port of the JAX package's ``training/train.py``.  ``make_train_step(cfg,
opt)`` returns ``train_step(state, batch) -> (state, metrics)``, one
program on one device or over a mesh (``launch.spmd.Program.train_step``):
the loss and its gradients through ``models.forward(mode="train")`` (K2
and K3 on the card, their plain versions' gradients; each pattern copy
recomputed in the backward when ``cfg.remat``, as the reference's scan
body is), the gradients' global norm clipped to ``max_grad_norm``, then
the optimizer's in-place update (``optimizer.py``).  The step reads
nothing back to the host: metrics are device scalars.  ``make_loss_fn``
and ``value_and_grad`` give one batch's loss and gradients alone.

The loss materialises the (B, S, V) f32 logits once, as the reference's
does.  Over a slice whose table is split over the vocabulary the logits
stay split too (``vocab_nll_sum``), as GSPMD keeps the reference's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.sharded import local_tree, on_shard
from repro_torch.models import (forward, init_params, params_from_numpy,
                                slices, stacked_leaves)
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _to_torch
from repro_torch.tree import named_leaves, tree_leaves, tree_map

from .optimizer import Optimizer, OptState


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState


def nll_sum(logits: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Σ of the (masked) token NLLs of f32 logits (B, S, V), targets (B, S)
    int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets.long()[..., None].to(
        logits.device), dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask.to(nll.device))
    return torch.sum(nll)


def vocab_nll_sum(logits: list, targets: torch.Tensor,
                  mask: torch.Tensor | None, tp) -> torch.Tensor:
    """``nll_sum`` of logits split over the vocabulary, on the slice's
    first device: ``logits`` each shard's f32 (B, S, V/m) slice (rows
    ``tp.vocab[s]`` of the table) on its device, in shard order.  What
    GSPMD makes of the reference's ``cross_entropy`` with ``vocab`` over
    'model': each shard's row max, reduced as a max over the shards
    (detached); Σ exp(x - max) and the target's logit (from the shard that
    owns it, zero elsewhere), each summed over the shards in shard order;
    nll = log Σ + max - gold.  Three (B, S) all-reduces move, never the
    logits; autograd gives the backward."""
    d0 = tp.devices[0]
    with torch.no_grad():
        top = None
        for x in logits:
            t = torch.amax(x, dim=-1).to(d0, non_blocking=True)
            top = t if top is None else torch.maximum(top, t)
    slices.record("all-reduce", top, tp.size)
    sums, golds = [], []
    for s, (x, d) in enumerate(zip(logits, tp.devices)):
        with on_shard(s):
            lo, hi = tp.vocab[s]
            local = targets.to(d, non_blocking=True).long() - lo
            hit = (local >= 0) & (local < hi - lo)
            gold = torch.take_along_dim(
                x, torch.where(hit, local, 0)[..., None], dim=-1)[..., 0]
            golds.append(torch.where(hit, gold, 0.0))
            shift = top.to(d, non_blocking=True)[..., None]
            sums.append(torch.sum(torch.exp(x - shift), dim=-1))
    total = slices.sum_ordered(sums, d0)
    gold = slices.sum_ordered(golds, d0)
    slices.record("all-reduce", total, tp.size)
    slices.record("all-reduce", gold, tp.size)
    nll = torch.log(total) + top - gold
    if mask is not None:
        return torch.sum(nll * mask.to(d0))
    return torch.sum(nll)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """The mean NLL of the (masked) tokens: logits (B,S,V) f32; targets
    (B,S) int."""
    n = (torch.clamp(torch.sum(mask), min=1.0) if mask is not None
         else targets.numel())
    return nll_sum(logits, targets, mask) / n


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
                    grad_accum: int = 1, max_grad_norm: float = 1.0,
                    mesh=None):
    """``train_step(state, batch) -> (state, metrics)``, the program of
    ``launch.spmd.Program.train_step``.  ``mesh``: a (data, model) or
    (pod, data, model) mesh, ``state`` and ``batch`` placed by the rules
    (``Program.place_state``, ``place_batch``); gradients reduced over the
    batch rows and the shards that replicate a leaf, the global norm over
    every shard's leaves, the optimizer's update on each shard's local
    leaves.  Without a mesh the step runs over a one-device mesh of the
    state's device (``launch.mesh.device_mesh``), whose placement holds
    the given tensors themselves: it takes and returns an unplaced
    ``TrainState``, updated in place."""
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.spmd import Program

    kw = dict(grad_accum=grad_accum, max_grad_norm=max_grad_norm)
    if mesh is not None:
        return Program(cfg, mesh).train_step(opt, **kw)
    programs: dict = {}

    def train_step(state: TrainState, batch):
        dev = state.opt_state.step.device
        if dev not in programs:
            prog = Program(cfg, device_mesh(dev))
            programs[dev] = prog, prog.train_step(opt, **kw)
        prog, step = programs[dev]
        placed, metrics = step(prog.place_state(state, opt.name),
                               prog.place_batch(batch))
        return local_tree(placed, 0), metrics

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
