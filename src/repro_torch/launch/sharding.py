"""Logical-axis sharding rules, and tensors placed over a mesh.

Port of the JAX package's ``launch/sharding.py`` (MaxText-style rules with
per-config divisibility fallbacks and per-leaf mesh-axis dedup).  Every
param / cache / pool leaf carries a tuple of logical axis names
(``models.param_axes``, ``cache_axes``, ``paged_pool_axes``).
``make_rules`` resolves names to mesh axes for a (config, mesh, shape);
``leaf_spec`` assigns mesh axes to a leaf's dims in PRIORITY order,
skipping mesh axes the leaf already uses — so llama4's 40 heads (not
divisible by model=16) fall back to sharding the attention weights' embed
dim under fsdp instead of replicating them.

A spec is a tuple with one entry per leaf dim: None (replicated), a mesh
axis name, or a tuple of names (``PartitionSpec``'s entries).  The
placed tensors themselves (``Placement``, ``ShardedTensor``, ``place``,
``gather``, ``reshard``) are format code in ``core.sharded``, re-exported
here; this module keeps the rules, which read model configs.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.sharded import (Placement, ShardedTensor, full,
                                      local_tree, place, place_tree, reshard)
from repro_torch.models.config import ModelConfig

from .mesh import Mesh

__all__ = ["Placement", "ShardedTensor", "batch_shardings", "full",
           "kv_pool_shardings", "leaf_spec", "local_tree", "make_rules",
           "map_axes", "opt_state_axes", "param_shardings", "place",
           "place_tree", "reshard", "tensor_parallel", "tree_shardings"]

# Leaf-dim assignment priority: most valuable shardings first.
_PRIORITY = ("expert", "vocab", "ffn", "heads", "kv_heads", "ssm_heads",
             "cache_seq", "cache_batch", "batch", "seq", "embed", "layers")


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def make_rules(cfg: ModelConfig, mesh, *, batch: int | None = None,
               fsdp: bool = False, seq_shard_cache: bool | None = None
               ) -> dict:
    """Logical axis → mesh axis (or tuple of them, or None).  Reads only
    ``mesh.axis_names`` and ``mesh.devices.shape``."""
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    model = axes.get("model", 1)
    data = axes.get("data", 1)
    pod = axes.get("pod", 1)

    # batch axes: largest prefix of (pod, data) that divides the batch
    batch_axes: tuple[str, ...] = ()
    if batch is not None:
        if "pod" in axes and _div(batch, pod * data):
            batch_axes = ("pod", "data")
        elif _div(batch, data):
            batch_axes = ("data",)
    long_ctx = seq_shard_cache if seq_shard_cache is not None \
        else (batch == 1)

    return {
        "vocab": "model" if _div(cfg.vocab_size, model) else None,
        "embed": ("data" if fsdp and _div(cfg.d_model, data) else None),
        "heads": "model" if _div(cfg.n_heads, model) else None,
        "kv_heads": "model" if _div(cfg.n_kv_heads, model) else None,
        "ssm_heads": ("model" if cfg.ssm_state and _div(cfg.ssm_heads, model)
                      else None),
        "ffn": "model",
        "expert": ("data" if cfg.n_experts and _div(cfg.n_experts, data) else
                   ("model" if cfg.n_experts and _div(cfg.n_experts, model)
                    else None)),
        "layers": None,
        "batch": batch_axes or None,
        "seq": None,
        "cache_batch": batch_axes or None,
        "cache_seq": ("data" if long_ctx else None),
        None: None,
    }


def leaf_spec(axes_tuple: tuple, rules: dict) -> tuple:
    """Resolve one leaf's logical axes with priority + per-leaf dedup."""
    n = len(axes_tuple)
    resolved: list[Any] = [None] * n
    used: set[str] = set()
    order = sorted(range(n), key=lambda i: _PRIORITY.index(axes_tuple[i])
                   if axes_tuple[i] in _PRIORITY else len(_PRIORITY))
    for i in order:
        target = rules.get(axes_tuple[i])
        if target is None:
            continue
        targets = target if isinstance(target, tuple) else (target,)
        free = tuple(t for t in targets if t not in used)
        if not free:
            continue
        resolved[i] = free if len(free) > 1 else free[0]
        used.update(free)
    return tuple(resolved)


def is_axes_leaf(x) -> bool:
    """A tuple of logical axis names (or None): one leaf of an axes tree."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_axes(fn: Callable, tree: Any) -> Any:
    """``tree`` (dicts, lists and tuples of axes tuples) with each axes
    tuple replaced by ``fn(axes)``."""
    if is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    vals = [map_axes(fn, v) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


# ================================================================== trees
def tree_shardings(axes_tree, mesh: Mesh, rules: dict):
    """Map an axes tree (``param_axes`` / ``cache_axes`` /
    ``paged_pool_axes``) to Placements."""
    return map_axes(lambda a: Placement(mesh, leaf_spec(a, rules)),
                    axes_tree)


def param_shardings(cfg: ModelConfig, mesh: Mesh, **rule_kw):
    """Placements of a model's param tree on ``mesh`` (the serving-side
    install: ``place_tree(params, param_shardings(cfg, mesh))``)."""
    from repro_torch.models import param_axes

    return tree_shardings(param_axes(cfg), mesh,
                          make_rules(cfg, mesh, **rule_kw))


def kv_pool_shardings(cfg: ModelConfig, mesh: Mesh, *,
                      kv_dtype: str | None = None):
    """Placements of the serving engines' paged KV pool.  K/V leaves are
    (num_blocks, block_size, kv_heads, head_dim) per layer: kv_heads splits
    over 'model' when divisible (the attention weights' rule), block and
    slot dims replicate because block tables are host-side and every shard
    scatters any (block, slot).  Quantized pools' f32 scale leaves
    (num_blocks, block_size, kv_heads) follow the same split, so the whole
    tree spills, adopts and donates with per-leaf exact-match
    placements."""
    from repro_torch.models import paged_pool_axes

    return tree_shardings(paged_pool_axes(cfg, kv_dtype=kv_dtype), mesh,
                          make_rules(cfg, mesh))


def batch_shardings(batch_tree_shapes: dict, mesh: Mesh, rules: dict):
    """Placements of a data batch: leading dim = batch, rest replicated."""
    b = rules.get("batch")

    def spec(x):
        nd = len(x.shape)
        return Placement(mesh, (b,) + (None,) * (nd - 1) if b else ())

    return {k: spec(v) for k, v in batch_tree_shapes.items()}


def tensor_parallel(cfg: ModelConfig, mesh: Mesh, *, rules: dict | None = None,
                    row: int = 0):
    """How a step runs over row ``row`` of ``mesh``'s 'model' axis
    (``models.TensorParallel``), from the rules the params are placed by
    (``rules``, default ``make_rules(cfg, mesh)``).  Row r is the r-th
    group of 'model' shards in mesh order ('model' is the last axis); over
    m > 1 shards the step splits q heads, kv heads, ffn columns, the vocab
    and Mamba-2's SSM heads over 'model' where the rules do.  A one-device
    row splits nothing.

    Where the q heads split and the kv heads do not (``n_kv_heads % m``),
    every shard holds the whole cache or pool and its q heads read one kv
    head of it: each shard's H/m heads must lie in one kv-head group."""
    from repro_torch.models import TensorParallel, layer_specs
    from repro_torch.models.mamba2 import shard_columns

    names = mesh.axis_names
    if "model" in names and names[-1] != "model":
        raise ValueError(f"'model' must be the last mesh axis, got {names}")
    m = mesh.shape.get("model", 1)
    if not 0 <= row < mesh.size // m:
        raise ValueError(f"row {row} outside the mesh's {mesh.size // m}")
    devices = tuple(ld.device for ld in
                    list(mesh.devices.flat)[row * m:(row + 1) * m])
    if m == 1:
        return TensorParallel(devices=devices)
    rules = make_rules(cfg, mesh) if rules is None else rules
    if rules["expert"] == "model":
        raise ValueError(f"config {cfg.name}: the sharded step splits no "
                         f"experts over 'model' (n_experts={cfg.n_experts}, "
                         f"model={m})")
    heads = rules["heads"] == "model"
    kv_split = rules["kv_heads"] == "model"
    kv_heads: list = [None] * m
    if heads and not kv_split:
        local, group = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
        if group % local:
            raise ValueError(
                f"config {cfg.name} at model={m}: a shard's {local} q heads "
                f"straddle the kv-head groups of {group}")
        kv_heads = [(s * local // group, s * local // group + 1)
                    for s in range(m)]
    vocab = None
    if rules["vocab"] == "model":
        pl = Placement(mesh, leaf_spec(("vocab", "embed"), rules))
        vocab = tuple((r[0].start, r[0].stop)
                      for r in pl.slices((cfg.vocab_size, cfg.d_model))[:m])
    ffn = rules["ffn"] == "model"
    ssm = ffn and any(s.kind == "mamba" for s in layer_specs(cfg))
    if ssm:
        shard_columns(cfg, m)          # raises unless the heads divide
    return TensorParallel(devices=devices, heads=heads, ffn=ffn, vocab=vocab,
                          kv_heads=tuple(kv_heads), ssm=ssm,
                          ssm_state=ssm and rules["heads"] == "model")


# ========================================================= optimizer state
class _Axes:
    """An axes tuple held opaque, so tree walkers treat it as one leaf."""

    def __init__(self, axes: tuple) -> None:
        self.axes = axes


def opt_state_axes(opt_name: str, param_axes_tree, cfg: ModelConfig):
    """Axes tree of the port's ``OptState`` for a params axes tree
    (``training/optimizer.py``): moments keyed by the JAX leaf names of
    ``models.stacked_leaves``.  AdamW's moments mirror the params (a
    stacked leaf's moment is the tuple of its layers' axes); Adafactor's
    factored statistics are kept on the stacked leaf, so theirs carry the
    leading "layers" axis, as in the JAX package."""
    from repro_torch.models import stacked_leaves
    from repro_torch.training.optimizer import OptState

    leaves = stacked_leaves(map_axes(_Axes, param_axes_tree), cfg)
    unwrap = lambda v: (tuple(a.axes for a in v) if isinstance(v, tuple)
                        else v.axes)
    stacked = lambda v: (("layers",) + v[0].axes if isinstance(v, tuple)
                         else v.axes)
    if opt_name == "adamw":
        mu = {name: unwrap(v) for name, v in leaves.items()}
        return OptState(step=(), mu=mu, nu=dict(mu))
    if opt_name == "adafactor":
        def nu_axes(a):
            if len(a) >= 2:
                return {"row": tuple(a[:-1]), "col": tuple(a[:-2]) + (a[-1],)}
            return {"full": tuple(a)}

        return OptState(step=(), mu={name: () for name in leaves},
                        nu={name: nu_axes(stacked(v))
                            for name, v in leaves.items()})
    raise ValueError(opt_name)
