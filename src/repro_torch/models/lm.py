"""Decoder LM over the segment/pattern layout: the full-sequence forward,
the dense prefill / decode steps and the paged serving step.

Port of the JAX package's ``models/lm.py`` for models of ``attn_mlp``,
``attn_moe``, ``mamba`` and ``shared_attn`` layers (the pure-attention
configs, the MoE configs, mamba2 and zamba2) and for both input modes:
token ids, or a frontend's embeddings (``input_mode="embeds"``: musicgen's
EnCodec frames, phi-3-vision's patch and text embeddings) that enter the
stack as they are, cast to the model's dtype.  ``forward`` scores whole
sequences (attention through K2, the flash-attention kernel; the SSD scan
through K3) and, in train mode under grad, is what the training step
differentiates; ``prefill`` and ``decode_step`` run the dense per-slot caches
(prefill through K2 and K3, decode attention through K4);
``paged_mixed_step`` runs one packed tick
against the paged KV pool, and ``paged_prefill`` / ``paged_decode_step``
the phase-separated steps over it (attention through K1 in all three).  One
layer loop (``_layer``: an attention half, then an MLP half; a Mamba-2
block; zamba2's shared block) serves them all, over a slice
(``TensorParallel``: one shard when unsharded), each half on every shard,
the partials reduced between them in shard order (``slices``).  A mesh
of several slices (a 'data' axis) is driven by ``launch.spmd``.
The JAX package scans each segment over
``repeat`` stacked parameter copies; the port keeps one flat list of layers
in the same order (``layer_specs``): layer ``r·len(pattern) + i`` of a
segment is pattern position ``i`` of copy ``r``.  For gemma2 (``Segment((local,
global), 21)``) even layers are local (windowed) and odd layers global; for
zamba2 (``Segment((mamba,) * 6 + (shared_attn,), 9)``) every seventh layer
applies the shared attention block.  ``params_from_numpy``,
``pools_from_numpy`` and ``caches_from_numpy`` unstack in exactly that order.

Params: ``{"embed": {"table"}, "final_norm": {"scale"}, "layers": [layer
dict, ...]}`` (+ ``"head"`` for untied embeddings, + ``"shared_attn"`` for
zamba2, whose layer dicts of the shared-attention applications are empty,
as in the JAX package); each layer dict has the JAX leaf names and layouts
(an ``attn_moe`` layer's ``"moe"`` subtree keeps its router in f32).  An
embeds config keeps the ``"embed"`` table too, as the reference does: tied,
it is musicgen's head; untied, phi-3-vision's is never read.
Pools and caches: a list with one dict per layer, updated in place by the
step that uses them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.sharded import on_shard
from repro_torch.tree import named_leaves, tree_map

from . import attention as attn_mod
from . import mamba2 as mamba_mod
from . import slices
from .config import LayerSpec, ModelConfig
from .layers import (dtype_of, embed_axes, embed_init, embed_lookup, rmsnorm,
                     rmsnorm_axes, rmsnorm_init, softcap, unembed)
from .mlp import mlp, mlp_axes, mlp_init
from .moe import moe, moe_axes, moe_init, moe_rows
from .slices import TensorParallel

_PORTED_KINDS = {"attn_mlp", "attn_moe", "mamba", "shared_attn"}


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """The flat layer order of the stack (segment, then copy, then pattern
    position) — the order of ``params["layers"]``, the pools and the
    caches."""
    return [spec for seg in cfg.layout() for _ in range(seg.repeat)
            for spec in seg.pattern]


def supports_paged(cfg: ModelConfig) -> bool:
    """Paged KV serving needs token inputs (the prefix trie is keyed by
    token blocks) and pure-attention layers (SSM/conv state is O(1) per
    request and carries the whole history: it cannot be block-shared)."""
    return cfg.input_mode == "tokens" and all(
        s.kind in ("attn_mlp", "attn_moe")
        for seg in cfg.layout() for s in seg.pattern)


def supports_speculative(cfg: ModelConfig) -> bool:
    """Multi-token verify rows and their KV rollback need the paged path."""
    return supports_paged(cfg)


def _check_ported(cfg: ModelConfig, *, paged: bool = False) -> None:
    kinds = {s.kind for s in layer_specs(cfg)}
    if not kinds <= _PORTED_KINDS:
        raise NotImplementedError(
            f"config {cfg.name}: the port runs models of "
            f"{sorted(_PORTED_KINDS)} layers, not {sorted(kinds)}")
    if paged and not supports_paged(cfg):
        raise ValueError(f"config {cfg.name} cannot use the paged KV pool: "
                         f"its {sorted(kinds)} layers carry state that "
                         f"blocks cannot share (serve it with paged=False)")


# ====================================================================== init
def _block_init(generator, cfg: ModelConfig, spec: LayerSpec, device) -> dict:
    d = cfg.d_model
    if spec.kind == "mamba":
        return {"norm": rmsnorm_init(d, device),
                "mamba": mamba_mod.mamba_init(generator, cfg, device)}
    if spec.kind == "shared_attn":
        return {}       # parameters live in params["shared_attn"]
    p = {"norm_attn": rmsnorm_init(d, device),
         "attn": attn_mod.attn_init(generator, cfg, device),
         "norm_mlp": rmsnorm_init(d, device)}
    if cfg.post_norm:
        p["post_norm_attn"] = rmsnorm_init(d, device)
        p["post_norm_mlp"] = rmsnorm_init(d, device)
    if spec.kind == "attn_moe":
        p["moe"] = moe_init(generator, cfg, device)
    else:
        p["mlp"] = mlp_init(generator, cfg, device)
    return p


def _shared_attn_init(generator, cfg: ModelConfig, device) -> dict:
    """zamba2's one shared transformer block: it reads concat(hidden,
    embeddings), 2·d wide, and writes d."""
    d2 = 2 * cfg.d_model
    return {"norm_attn": rmsnorm_init(d2, device),
            "attn": attn_mod.attn_init(generator, cfg, device, d_in=d2),
            "norm_mlp": rmsnorm_init(d2, device),
            "mlp": mlp_init(generator, cfg, device, d_in=d2)}


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Seeded random weights, made directly on ``device``.  Same
    distributions as the JAX initialisers (N(0,1) embedding table, dense
    weights N(0, 1/fan_in), zero norm scales, A_log = dt_bias = 0, D = 1,
    the MoE router in f32); the draws differ, since the two frameworks'
    generators differ.  On the meta device nothing is drawn: the leaves
    are shapes and dtypes (the dry run)."""
    _check_ported(cfg)
    if generator is None and torch.device(device).type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    dt = dtype_of(cfg)
    specs = layer_specs(cfg)
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
        "layers": [_block_init(generator, cfg, spec, device)
                   for spec in specs],
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(generator, cfg.vocab_size, cfg.d_model,
                                    dt, device)
    if any(s.kind == "shared_attn" for s in specs):
        params["shared_attn"] = _shared_attn_init(generator, cfg, device)
    return params


# ============================================================ logical axes
# The logical axes of every leaf, for launch.sharding: trees of the port's
# layout (one entry per layer), so the JAX package's leading "layers" axis
# of a stacked segment leaf is dropped.
def _block_axes(cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.kind == "mamba":
        return {"norm": rmsnorm_axes(), "mamba": mamba_mod.mamba_axes(cfg)}
    if spec.kind == "shared_attn":
        return {}
    p = {"norm_attn": rmsnorm_axes(), "attn": attn_mod.attn_axes(cfg),
         "norm_mlp": rmsnorm_axes()}
    if cfg.post_norm:
        p["post_norm_attn"] = rmsnorm_axes()
        p["post_norm_mlp"] = rmsnorm_axes()
    if spec.kind == "attn_moe":
        p["moe"] = moe_axes(cfg)
    else:
        p["mlp"] = mlp_axes()
    return p


def _shared_attn_axes(cfg: ModelConfig) -> dict:
    return {"norm_attn": rmsnorm_axes(), "attn": attn_mod.attn_axes(cfg),
            "norm_mlp": rmsnorm_axes(), "mlp": mlp_axes()}


def param_axes(cfg: ModelConfig) -> dict:
    """Logical axes tree mirroring ``init_params``."""
    specs = layer_specs(cfg)
    axes = {"embed": embed_axes(), "final_norm": rmsnorm_axes(),
            "layers": [_block_axes(cfg, spec) for spec in specs]}
    if not cfg.tie_embeddings:
        axes["head"] = embed_axes()
    if any(s.kind == "shared_attn" for s in specs):
        axes["shared_attn"] = _shared_attn_axes(cfg)
    return axes


def cache_axes(cfg: ModelConfig) -> list[dict]:
    """Logical axes of the dense caches (``init_decode_caches``)."""
    return [mamba_mod.mamba_cache_axes() if spec.kind == "mamba"
            else attn_mod.cache_axes() for spec in layer_specs(cfg)]


def paged_pool_axes(cfg: ModelConfig, kv_dtype: str | None = None
                    ) -> list[dict]:
    """Logical axes of the paged pool (``init_paged_pools``)."""
    return [attn_mod.paged_pool_axes(cfg, kv_dtype=kv_dtype)
            for _ in layer_specs(cfg)]


# ===================================================== numpy <-> the port
_RAW_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
             "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _to_torch(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16 / float8_e4m3fn arrays, read as
    raw bits) → tensor on ``device``."""
    a = np.array(a)                      # a writable copy the port owns
    if a.dtype.name in _RAW_BITS:
        bits, dt = _RAW_BITS[a.dtype.name]
        return torch.from_numpy(a.view(bits)).view(dt).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor → numpy; bfloat16 and float8_e4m3fn leaves (which numpy
    lacks) come back as their raw bits (uint16 / uint8)."""
    # lint: allow-sync(offline numpy conversion for tests; no tick calls it)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _unstack(segments, cfg: ModelConfig, fn) -> list:
    """Per-layer trees, in ``layer_specs`` order, from the JAX package's
    tuple (segment) of tuples (pattern position) of stacked trees."""
    out = []
    for seg, seg_tree in zip(cfg.layout(), segments):
        for r in range(seg.repeat):
            for i in range(len(seg.pattern)):
                out.append(tree_map(lambda a, r=r: fn(a[r]), seg_tree[i]))
    return out


def _copies_by_position(layers: list, cfg: ModelConfig) -> list:
    """The layers grouped as the JAX package stacks them: a list per
    segment of a list per pattern position of that position's ``repeat``
    layers, in repeat order."""
    out, li = [], 0
    for seg in cfg.layout():
        n = len(seg.pattern)
        out.append([[layers[li + r * n + i] for r in range(seg.repeat)]
                    for i in range(n)])
        li += seg.n_layers
    return out


def _restack(layers: list[dict], cfg: ModelConfig):
    """The inverse of ``_unstack`` to numpy: tuple per segment of tuple per
    pattern position of dicts of stacked numpy leaves (see ``_to_numpy``)."""
    return tuple(
        tuple({k: np.stack([_to_numpy(c[k]) for c in copies])
               for k in copies[0]} for copies in seg)
        for seg in _copies_by_position(layers, cfg))


def stacked_leaves(tree, cfg: ModelConfig) -> dict:
    """The JAX package's params tree, flattened, over a port tree of the
    params' layout (params, grads or anything shaped alike): leaf name (the
    JAX path: ``embed/table``, ``segments/<s>/<i>/mamba/in_proj``, ...) →
    the port's tensor, or, for a leaf the JAX package stacks on a segment's
    ``repeat`` axis, the tuple of the port's per-layer tensors in repeat
    order.  In the JAX package's flatten order: dict keys sorted, segments
    and pattern positions in order."""
    segments = tuple(tuple(tree_map(lambda *ts: ts, *copies)
                           for copies in seg)
                     for seg in _copies_by_position(tree["layers"], cfg))
    top = {k: v for k, v in tree.items() if k != "layers"}
    top["segments"] = segments
    stacked = lambda node: isinstance(node, tuple) and bool(node) and \
        not isinstance(node[0], (dict, list, tuple))
    return dict(named_leaves(top, is_leaf=stacked))


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """The port's params from a JAX ``init_params`` tree after
    ``jax.tree.map(np.asarray, ...)``, unstacking each segment's ``repeat``
    axis into the flat layer order."""
    _check_ported(cfg)
    conv = lambda a: _to_torch(a, device)
    params = {"embed": tree_map(conv, tree["embed"]),
              "final_norm": tree_map(conv, tree["final_norm"]),
              "layers": _unstack(tree["segments"], cfg, conv)}
    for key in ("head", "shared_attn"):
        if key in tree:
            params[key] = tree_map(conv, tree[key])
    return params


def pools_from_numpy(tree, cfg: ModelConfig, device="cuda") -> list[dict]:
    """The port's per-layer pools from a JAX ``init_paged_pools`` tree
    (numpy leaves (repeat, num_blocks, bs, K, D) / (repeat, num_blocks, bs,
    K))."""
    return _unstack(tree, cfg, lambda a: _to_torch(a, device))


def pools_to_numpy(pools: list[dict], cfg: ModelConfig):
    """The inverse of ``pools_from_numpy``: the JAX pool tree layout (tuple
    per segment of tuple per pattern position of dicts of stacked numpy
    leaves).  bfloat16 / fp8 leaves come back as raw bits (see
    ``_to_numpy``)."""
    return _restack(pools, cfg)


def spilled_from_numpy(tree, cfg: ModelConfig) -> list[dict]:
    """The port's ``SpilledKV.blocks`` (one dict of CPU tensors per layer,
    leaves (n_blocks, bs, K, D) / (n_blocks, bs, K)) from a JAX
    ``SpilledKV.blocks`` tree (numpy leaves (repeat, n_blocks, bs, K, D) per
    segment and pattern position): a session spilled by the JAX engine
    resumes on the port's."""
    return _unstack(tree, cfg, lambda a: _to_torch(a, "cpu"))


def spilled_to_numpy(blocks: list[dict], cfg: ModelConfig):
    """The inverse of ``spilled_from_numpy``: the JAX ``SpilledKV.blocks``
    tree (bfloat16 / fp8 leaves as raw bits, see ``_to_numpy``)."""
    return _restack(blocks, cfg)


def caches_from_numpy(tree, cfg: ModelConfig, device="cuda") -> list[dict]:
    """The port's per-layer dense caches from a JAX ``init_decode_caches``
    (or ``prefill`` / ``decode_step``) tree: one ``{"k", "v", "pos"}`` per
    attention layer and per shared-attention application, one ``{"conv",
    "ssm"}`` per mamba layer, in ``layer_specs`` order."""
    return _unstack(tree, cfg, lambda a: _to_torch(a, device))


def caches_to_numpy(caches: list[dict], cfg: ModelConfig):
    """The inverse of ``caches_from_numpy``: the JAX cache tree layout, with
    stacked numpy leaves (bfloat16 as raw bits)."""
    return _restack(caches, cfg)


def init_paged_pools(cfg: ModelConfig, num_blocks: int, block_size: int,
                     kv_dtype: str | None = None, *,
                     device="cuda") -> list[dict]:
    """The global KV block pool: one dict per layer (``layer_specs`` order)
    of (num_blocks, block_size, K, D) leaves, plus scale leaves for int8 /
    fp8 pools (``kv_dtype`` defaults to ``cfg.kv_dtype``)."""
    _check_ported(cfg, paged=True)
    return [attn_mod.init_paged_pool(cfg, num_blocks, block_size,
                                     kv_dtype=kv_dtype, device=device)
            for _ in layer_specs(cfg)]


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                       device="cuda") -> list[dict]:
    """Dense decode caches, one dict per layer (``layer_specs`` order):
    attention layers and shared-attention applications get (batch, S_c,
    K, D) K/V and (batch, S_c) positions, all empty; mamba layers a zero
    conv window and f32 SSM state."""
    _check_ported(cfg)
    return [mamba_mod.mamba_cache_init(cfg, batch, device=device)
            if spec.kind == "mamba"
            else attn_mod.init_cache(cfg, spec, batch, max_len, device=device)
            for spec in layer_specs(cfg)]


# ==================================================================== blocks
def _embed_inputs(embed, inputs, cfg: ModelConfig):
    """(B, S, d) activations: token ids looked up in ``embed`` (the table's
    dict; scaled, where the config says so), or a frontend's embeddings
    cast to the model's dtype, with no lookup and no scale, as in the JAX
    package."""
    if cfg.input_mode == "embeds":
        return inputs.to(dtype_of(cfg))
    return embed_lookup(embed, inputs, scale=cfg.embed_scale, d=cfg.d_model)


def _head(params, x, cfg: ModelConfig):
    """Final norm + unembed (f32 logits) + final softcap."""
    x = rmsnorm(params["final_norm"], x)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return softcap(unembed(table, x), cfg.final_logit_softcap)


def _attn_half(p, x, positions, *, cfg: ModelConfig, spec: LayerSpec,
               mode: str, cache=None, max_len=None, pool=None,
               block_table=None, row_ids=None, kv_heads=None,
               partial: bool = False, seq=None):
    """The attention of an attn_mlp / attn_moe layer (or, given the shared
    block's params, of zamba2's shared block) after its norm: (y, the
    layer's new cache or None).  ``mode`` "score" attends over whole
    sequences, "prefill" also builds the layer's dense cache for
    ``max_len`` positions, "decode" reads and updates ``cache``, "paged"
    runs against ``pool`` (the packed row x (T, d) with ``row_ids``, or x
    (B, T, d) with ``row_ids`` None, row b on ``block_table`` row b).
    ``kv_heads`` and ``partial`` are a tensor-parallel shard's: the kv
    heads its q heads read of a replicated cache or pool, and its
    unrounded f32 share of the ``wo`` product; ``seq``: decode over a
    cache split over the sequence (``attention.attention``)."""
    h = rmsnorm(p["norm_attn"], x)
    kw = dict(cfg=cfg, spec=spec, kv_heads=kv_heads, partial=partial)
    if mode == "paged":
        return attn_mod.paged_attention(
            p["attn"], h, positions, pool=pool, block_table=block_table,
            row_ids=row_ids, **kw), None
    if mode == "prefill":
        return attn_mod.prefill_cache(p["attn"], h, positions,
                                      max_len=max_len, **kw)
    return attn_mod.attention(p["attn"], h, positions, cache=cache, seq=seq,
                              **kw)


def _mlp_half(p, x, *, cfg: ModelConfig, spec: LayerSpec,
              partial: bool = False):
    """The MLP (or MoE) half: (y, the MoE aux loss or None).  ``partial``:
    a tensor-parallel shard's f32 shares (``mlp``, ``moe``)."""
    h = rmsnorm(p["norm_mlp"], x)
    kw = {"partial": True} if partial else {}
    if spec.kind == "attn_moe":
        return moe(p["moe"], h, cfg=cfg, **kw)
    return mlp(p["mlp"], h, **kw), None


def _residual(p, post_norm: str, x, y, cfg: ModelConfig):
    """x + y, y through the layer's post-norm where the config has one
    (gemma2: normalised over the full d, so after any reduction)."""
    if cfg.post_norm:
        y = rmsnorm(p[post_norm], y)
    return x + y


def _copies(cfg: ModelConfig):
    """(first layer, pattern) of every pattern copy, in layer order: the
    bodies of the JAX package's scans over each segment's repeat axis."""
    li = 0
    for seg in cfg.layout():
        for _ in range(seg.repeat):
            yield li, seg.pattern
            li += len(seg.pattern)


# ================================================================= slices
def _as_slice(params, tp: TensorParallel | None):
    """(params, tp) as a slice: an unsharded call's tree becomes a slice of
    one shard on its device."""
    if tp is not None:
        return params, tp
    dev = params["final_norm"]["scale"].device
    return [params], TensorParallel(devices=(dev,))


def _use_at(shards: list, tp: TensorParallel, s: int, *path):
    """Shard s's params at ``path`` (a layer's dict, zamba2's shared block,
    a table), with the leaves that the rows split gathered whole at this
    use (``tp.gather``: params over 'data'), or as they are."""
    node = shards[s]
    for k in path:
        node = node[k]
    if tp.gather is None:
        return node
    with on_shard(s):
        return tp.gather(s, path, node)


def _use(shards: list, tp: TensorParallel, *path) -> list:
    return [_use_at(shards, tp, s, *path) for s in range(len(shards))]


def _embed(params: list, inputs: dict, cfg: ModelConfig,
           tp: TensorParallel) -> dict:
    """The activations on every device.  A split table: each shard looks
    up the tokens in its rows and zeros elsewhere, and the lookups are
    summed in shard order (exact: one term is nonzero)."""
    if cfg.input_mode == "embeds":
        return {d: _embed_inputs(None, inputs[d], cfg) for d in tp.first}
    if tp.vocab is None:
        return {d: _embed_inputs(_use_at(params, tp, s, "embed"), inputs[d],
                                 cfg) for d, s in tp.first.items()}
    looked = []
    for s, d in enumerate(tp.devices):
        table = _use_at(params, tp, s, "embed")
        with on_shard(s):
            lo, hi = tp.vocab[s]
            local = inputs[d] - lo
            hit = (local >= 0) & (local < hi - lo)
            x = embed_lookup(table, torch.where(hit, local, 0),
                             scale=cfg.embed_scale, d=cfg.d_model)
            looked.append(torch.where(hit[..., None], x, 0))
    out = {d: slices.sum_ordered(looked, d) for d in tp.first}
    slices.record("all-reduce", looked[0], tp.size)
    return out


def _slice_head(params: list, rows: dict, cfg: ModelConfig,
                tp: TensorParallel, split: bool = False):
    """Final norm + unembed + softcap of ``rows`` (the rows to score, on
    every device) on the first shard's device; a split table's logits
    concatenated in shard order (an all-gather).  ``split`` with a split
    table: each shard's softcapped (..., V/m) logits on its own device, a
    list in shard order, and no gather."""
    d0 = tp.devices[0]
    key = "embed" if cfg.tie_embeddings else "head"
    if tp.vocab is None:
        return _head({"final_norm": params[0]["final_norm"],
                      key: _use_at(params, tp, 0, key)}, rows[d0], cfg)
    logits = []
    for s, d in enumerate(tp.devices):
        table = _use_at(params, tp, s, key)
        with on_shard(s):
            h = rmsnorm(params[s]["final_norm"], rows[d])
            y = unembed(table, h)
            logits.append(softcap(y, cfg.final_logit_softcap) if split
                          else y.to(d0, non_blocking=True))
    if split:
        return logits
    out = softcap(torch.cat(slices.tiled(logits, tp.size), dim=-1),
                  cfg.final_logit_softcap)
    slices.record("all-gather", out, tp.size)
    return out


def _attn_part(ps, xs, positions, caches, *, cfg, spec, tp, mode, max_len,
               paged):
    """The attention half of an attn_mlp / attn_moe layer over the slice:
    on every shard, its partials reduced, then the residual.  Returns (xs,
    the shards' new caches)."""
    outs = slices.per_shard(tp, lambda s, d: _attn_half(
        ps[s], xs[d], positions[d], cfg=cfg, spec=spec, mode=mode,
        cache=None if caches is None else caches[s], max_len=max_len,
        kv_heads=tp.kv_heads[s], partial=tp.heads, seq=tp.seq,
        **(paged[s] if paged else {})))
    y = slices.combine([o[0] for o in outs], tp, tp.heads, dtype_of(cfg))
    return ({d: _residual(ps[s], "post_norm_attn", xs[d], y[d], cfg)
             for d, s in tp.first.items()}, [o[1] for o in outs])


def _mlp_residual(ps, xs, ys: list, tp, cfg) -> dict:
    """The MLP halves' outputs (each shard's) reduced, then the
    residual."""
    y = slices.combine(ys, tp, tp.ffn, dtype_of(cfg))
    return {d: _residual(ps[s], "post_norm_mlp", xs[d], y[d], cfg)
            for d, s in tp.first.items()}


def _attn_layer(ps, xs, positions, caches, *, cfg, spec, tp, mode,
                max_len, paged):
    """An attn_mlp / attn_moe layer over the slice: the attention half on
    every shard, its partials reduced, the residual; then the MLP half
    likewise.  Returns (xs, the shards' new caches, the MoE aux)."""
    xs, new = _attn_part(ps, xs, positions, caches, cfg=cfg, spec=spec,
                         tp=tp, mode=mode, max_len=max_len, paged=paged)
    outs = slices.per_shard(tp, lambda s, d: _mlp_half(
        ps[s], xs[d], cfg=cfg, spec=spec, partial=tp.ffn))
    return (_mlp_residual(ps, xs, [o[0] for o in outs], tp, cfg), new,
            outs[0][1])


def _shared_layer(shared, xs, embeds0, positions, caches, *, cfg, spec, tp,
                  mode, max_len):
    """zamba2's shared block over the slice: attention and MLP read
    concat(hidden, the stack's input embeddings); each half's partials
    reduced like any split half.  Returns (xs, the shards' new caches)."""
    dt = dtype_of(cfg)
    u = {d: torch.cat([xs[d], embeds0[d]], dim=-1) for d in tp.first}
    outs = slices.per_shard(tp, lambda s, d: _attn_half(
        shared[s], u[d], positions[d], cfg=cfg, spec=spec, mode=mode,
        cache=None if caches is None else caches[s], max_len=max_len,
        kv_heads=tp.kv_heads[s], partial=tp.heads, seq=tp.seq))
    y = slices.combine([o[0] for o in outs], tp, tp.heads, dt)
    xs = {d: xs[d] + y[d] for d in tp.first}
    v = {d: torch.cat([xs[d], embeds0[d]], dim=-1) for d in tp.first}
    ys = slices.per_shard(tp, lambda s, d: mlp(
        shared[s]["mlp"], rmsnorm(shared[s]["norm_mlp"], v[d]),
        **({"partial": True} if tp.ffn else {})))
    y = slices.combine(ys, tp, tp.ffn, dt)
    return {d: xs[d] + y[d] for d in tp.first}, [o[1] for o in outs]


def _mamba_layer(ps, xs, caches, *, cfg, tp):
    """A Mamba-2 layer over the slice (``mamba2.mamba_slice``: split by SSM
    heads where ``tp.ssm``, else the whole block on every shard).  Returns
    (xs, the shards' new caches)."""
    hs = {d: rmsnorm(ps[s]["norm"], xs[d]) for d, s in tp.first.items()}
    y, new = mamba_mod.mamba_slice([p["mamba"] for p in ps], hs, cfg=cfg,
                                   tp=tp, caches=caches)
    return {d: xs[d] + y[d] for d in tp.first}, new


def _layer(shards, li, spec, xs, positions, *, cfg, tp, mode,
           caches=None, embeds0=None, max_len=None, paged=None):
    """Layer ``li`` over the slice: (xs, the shards' new caches (each None
    where the mode builds none), the MoE aux or None).  ``caches``: each
    shard's cache of this layer (decode; a mamba layer's prefill state)."""
    if spec.kind == "shared_attn":
        xs, new = _shared_layer(_use(shards, tp, "shared_attn"), xs,
                                embeds0, positions, caches, cfg=cfg,
                                spec=spec, tp=tp, mode=mode, max_len=max_len)
        return xs, new, None
    ps = _use(shards, tp, "layers", li)
    if spec.kind == "mamba":
        xs, new = _mamba_layer(ps, xs, caches, cfg=cfg, tp=tp)
        return xs, new, None
    return _attn_layer(ps, xs, positions, caches, cfg=cfg, spec=spec, tp=tp,
                       mode=mode, max_len=max_len, paged=paged)


# =================================================== slices in lockstep
class _Run(NamedTuple):
    """One slice of a run over several: its shards' param trees and its
    ``TensorParallel``."""
    shards: list
    tp: TensorParallel


def _layer_rows(runs: list, li, spec, xs: list, positions: list, *, cfg,
                mode, caches=None, embeds0=None, max_len=None):
    """Layer ``li`` over every slice of ``runs``, each as ``_layer``:
    (each slice's xs, new caches and aux).  Where the MoE layer's experts
    lie over the mesh's rows (``tp.experts``), every slice's attention
    half runs first, then the MoE halves in lockstep
    (``moe.moe_rows``: each owner runs the slots every slice sends it
    once), then each slice's reduction and residual."""
    n = len(runs)
    caches = [None] * n if caches is None else caches
    embeds0 = [None] * n if embeds0 is None else embeds0
    if spec.kind != "attn_moe" or runs[0].tp.experts is None:
        out = [_layer(r.shards, li, spec, x, p, cfg=cfg, tp=r.tp, mode=mode,
                      caches=c, embeds0=e, max_len=max_len)
               for r, x, p, c, e in zip(runs, xs, positions, caches,
                                        embeds0)]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]
    pss = [_use(r.shards, r.tp, "layers", li) for r in runs]
    halves = [_attn_part(ps, x, p, c, cfg=cfg, spec=spec, tp=r.tp,
                         mode=mode, max_len=max_len, paged=None)
              for r, ps, x, p, c in zip(runs, pss, xs, positions, caches)]
    calls = []
    for r, ps, (x, _) in zip(runs, pss, halves):
        for s, d in enumerate(r.tp.devices):
            with on_shard(s):
                calls.append((ps[s]["moe"], rmsnorm(ps[s]["norm_mlp"], x[d]),
                              r.tp.experts.at(li, s)))
    ys = iter(moe_rows(calls, cfg, partial=runs[0].tp.ffn))
    out = [_mlp_residual(ps, x, [next(ys) for _ in r.tp.devices], r.tp, cfg)
           for r, ps, (x, _) in zip(runs, pss, halves)]
    return out, [h[1] for h in halves], [None] * n


def _runs(rows: list, cfg: ModelConfig) -> tuple[list, list, list]:
    """(the runs, each slice's activations and positions on its devices)
    of ``rows`` (params, inputs, positions, tp)."""
    runs = [_Run(*_as_slice(r[0], r[-1])) for r in rows]
    xs = [_embed(run.shards, slices.on_devices(r[-3], run.tp), cfg, run.tp)
          for run, r in zip(runs, rows)]
    pos = [slices.on_devices(r[-2], run.tp) for run, r in zip(runs, rows)]
    return runs, xs, pos


# ============================================================ entry points
def forward_rows(rows: list, cfg: ModelConfig, *, mode: str = "score",
                 split_vocab: bool = False) -> list:
    """``forward`` of several slices in lockstep, layer by layer (the rows
    of a mesh whose rows hold the experts: a MoE group may span them):
    ``rows`` a list of (params, inputs, positions, tp); returns each one's
    (logits, aux)."""
    _check_ported(cfg)
    if mode not in ("score", "train"):
        raise ValueError(f"mode must be 'score' or 'train', got {mode!r}")
    if split_vocab and mode != "train":
        raise ValueError("split_vocab is a train-mode option")
    runs, xs, pos = _runs(rows, cfg)
    aux = [torch.zeros((), dtype=torch.float32, device=r.tp.devices[0])
           for r in runs]
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()

    def run_copy(li, pattern, xs, aux, embeds0):
        for i, spec in enumerate(pattern):
            xs, _, layer_aux = _layer_rows(runs, li + i, spec, xs, pos,
                                           cfg=cfg, mode="score",
                                           embeds0=embeds0)
            aux = [a if la is None else a + la
                   for a, la in zip(aux, layer_aux)]
        return xs, aux

    embeds0 = xs
    for li, pattern in _copies(cfg):
        if remat:
            xs, aux = torch.utils.checkpoint.checkpoint(
                run_copy, li, pattern, xs, aux, embeds0, use_reentrant=False)
        else:
            xs, aux = run_copy(li, pattern, xs, aux, embeds0)
    return [(_slice_head(r.shards, x, cfg, r.tp, split=split_vocab), a)
            for r, x, a in zip(runs, xs, aux)]


def forward(params, inputs, positions, cfg: ModelConfig, *,
            mode: str = "score", tp: TensorParallel | None = None,
            split_vocab: bool = False):
    """Full-sequence forward (no caches): inputs (B, S) int32 tokens or
    (B, S, d) embeddings (``input_mode="embeds"``), positions (B, S) int32
    (contiguous 0..S-1: K2 assumes them).  Returns (f32 logits (B, S, V),
    aux): aux is the f32 sum of the attn_moe layers'
    aux losses, in layer order (zero without MoE layers).

    ``mode="train"`` computes the same values.  Under grad with
    ``cfg.remat``, each pattern copy runs inside
    ``torch.utils.checkpoint`` (non-reentrant), as the JAX package wraps its
    scan body in ``jax.checkpoint``: the backward recomputes the copy's
    forward (K2 and K3 launch again) instead of keeping its activations.
    The kernels' gradients are their plain versions' (see their wrappers).

    ``tp``: a tensor-parallel slice; ``params`` is then the shards' local
    trees (a list, in mesh order) and the logits land on the first shard's
    device.  Without it, one param tree runs as a slice of one shard.
    With ``tp.experts`` (one row of a mesh whose rows hold the experts),
    aux is zero: the rows' chain forms the batch's (``moe.ExpertChain``).

    ``split_vocab`` (train mode): where ``tp`` splits the table over the
    vocabulary, the logits come back as each shard's softcapped (B, S,
    V/m) slice on its own device, a list in shard order, never gathered
    (``training.train.vocab_nll_sum`` takes them); elsewhere it changes
    nothing."""
    return forward_rows([(params, inputs, positions, tp)], cfg, mode=mode,
                        split_vocab=split_vocab)[0]


def prefill_rows(rows: list, cfg: ModelConfig, *, max_len: int) -> list:
    """``prefill`` of several slices in lockstep (see ``forward_rows``):
    each one's (logits, caches: one list per shard)."""
    _check_ported(cfg)
    runs, xs, pos = _runs(rows, cfg)
    embeds0 = xs
    caches = [[[] for _ in r.tp.devices] for r in runs]
    for li, spec in enumerate(layer_specs(cfg)):
        start = None
        if spec.kind == "mamba":
            start = [slices.per_shard(r.tp, lambda s, d, r=r, b=row[-3].shape[
                0]: mamba_mod.mamba_cache_init(cfg, b, device=d, tp=r.tp,
                                               shard=s))
                     for r, row in zip(runs, rows)]
        xs, new, _ = _layer_rows(runs, li, spec, xs, pos, cfg=cfg,
                                 mode="prefill", caches=start,
                                 embeds0=embeds0, max_len=max_len)
        for mine, got in zip(caches, new):
            for shard, c in zip(mine, got):
                shard.append(c)
    return [(_slice_head(r.shards, {d: x[:, -1:, :] for d, x in xs_.items()},
                         cfg, r.tp)[:, 0, :], c)
            for r, xs_, c in zip(runs, xs, caches)]


def prefill(params, inputs, positions, cfg: ModelConfig, *, max_len: int,
            tp: TensorParallel | None = None):
    """Run the prompt and build the dense decode caches: inputs (B, S)
    int32 tokens or (B, S, d) embeddings, positions (B, S) int32 (0..S-1,
    as the dense engine passes them).  Returns (f32 last-token logits (B,
    V), caches: one dict per layer, each for ``max_len`` positions).

    ``tp``: as in ``forward``; the caches are then one list per shard of
    its local caches (a kv-head split or replicated cache, a Mamba-2
    layer's local conv channels and SSM heads)."""
    logits, caches = prefill_rows([(params, inputs, positions, tp)], cfg,
                                  max_len=max_len)[0]
    return logits, (caches if tp is not None else caches[0])


def decode_rows(rows: list, cfg: ModelConfig) -> list:
    """``decode_step`` of several slices in lockstep (see
    ``forward_rows``): ``rows`` a list of (params, caches: one list per
    shard, inputs, positions, tp), each slice's caches updated in place;
    returns each one's logits."""
    tokens = cfg.input_mode == "tokens"
    rows = [(p, c, i[:, None] if tokens and i.dim() == 1 else i, q, tp)
            for p, c, i, q, tp in rows]
    runs, xs, pos = _runs([(r[0],) + r[2:] for r in rows], cfg)
    local = [r[1] if r[-1] is not None else [r[1]] for r in rows]
    embeds0 = xs
    for li, spec in enumerate(layer_specs(cfg)):
        layers = [[c[li] for c in mine] for mine in local]
        xs, new, _ = _layer_rows(runs, li, spec, xs, pos, cfg=cfg,
                                 mode="decode", caches=layers,
                                 embeds0=embeds0)
        if spec.kind == "mamba":
            for layer, got in zip(layers, new):
                for cache, nc in zip(layer, got):
                    for k, leaf in nc.items():
                        cache[k].copy_(leaf)
    return [_slice_head(r.shards, x, cfg, r.tp)[:, 0, :]
            for r, x in zip(runs, xs)]


def decode_step(params, caches, inputs, positions, cfg: ModelConfig, *,
                tp: TensorParallel | None = None):
    """One decode step: inputs (B,) or (B, 1) int32 tokens, or (B, 1, d)
    embeddings, positions (B, 1) int32.  Returns (f32 logits (B, V),
    caches).  ``caches`` (one dict per layer, from ``prefill`` or
    ``init_decode_caches``) is updated in place, where the JAX package
    returns new trees.  ``tp``: as in ``prefill`` (``caches`` one list per
    shard)."""
    return decode_rows([(params, caches, inputs, positions, tp)],
                       cfg)[0], caches


# ============================================================ paged steps
def _paged_layers(params: list, pools: list, inputs, positions, block_tables,
                  row_ids, cfg: ModelConfig, tp: TensorParallel) -> dict:
    """The lookup and every layer against the paged pools over the slice
    (``_layer`` in "paged" mode: each half on every shard, its partials
    reduced before the next half, only where the leaf is split;
    post-norms after the reduction).  The operands are copied to each
    shard's device (no copy where they lie already); returns the hidden
    states on every device."""
    xs = _embed(params, slices.on_devices(inputs, tp), cfg, tp)
    positions, block_tables, row_ids = (slices.on_devices(positions, tp),
                                        slices.on_devices(block_tables, tp),
                                        slices.on_devices(row_ids, tp))
    for li, spec in enumerate(layer_specs(cfg)):
        paged = [dict(pool=pools[s][li], block_table=block_tables[d],
                      row_ids=row_ids[d]) for s, d in enumerate(tp.devices)]
        xs, _, _ = _layer(params, li, spec, xs, positions, cfg=cfg, tp=tp,
                          mode="paged", paged=paged)
    return xs


def _one_shard(params, pools, tp: TensorParallel | None):
    """(params, pools, tp) as a slice: an unsharded call's trees become a
    slice of one shard on their device."""
    if tp is not None:
        return params, pools, tp
    shards, tp = _as_slice(params, None)
    return shards, [pools], tp


def paged_prefill(params, pools, block_tables, inputs, positions,
                  cfg: ModelConfig, *, tp: TensorParallel | None = None):
    """Prefill a (possibly block-aligned-truncated) prompt suffix against
    the paged pool: inputs (B, T) int32 suffix tokens, positions (B, T)
    int32 their absolute positions (row b starts at its reused prefix
    length), row b on ``block_tables`` row b.  The suffix attends to the
    reused prefix KV through the table without recomputing it (K1, its
    B·T tokens packed as lanes of rows 0..B-1).  Returns (f32 last-token
    logits (B, V), pools), the pools updated in place.  ``tp``: as in
    ``paged_mixed_step``."""
    shards, local, tp = _one_shard(params, pools, tp)
    xs = _paged_layers(shards, local, inputs, positions, block_tables, None,
                       cfg, tp)
    rows = {d: x[:, -1:, :] for d, x in xs.items()}
    return _slice_head(shards, rows, cfg, tp)[:, 0, :], pools


def paged_decode_step(params, pools, block_tables, inputs, positions,
                      cfg: ModelConfig, *, tp: TensorParallel | None = None):
    """One decode step over the paged pool: inputs (B,) or (B, 1) int32
    tokens, positions (B, 1) int32 (K1 with one token per row).  Returns
    (f32 logits (B, V), pools), the pools updated in place.  ``tp``: as in
    ``paged_mixed_step``."""
    if inputs.dim() == 1:
        inputs = inputs[:, None]
    shards, local, tp = _one_shard(params, pools, tp)
    xs = _paged_layers(shards, local, inputs, positions, block_tables, None,
                       cfg, tp)
    return _slice_head(shards, xs, cfg, tp)[:, 0, :], pools


def paged_mixed_step(params, pools, block_tables, tokens, positions, row_ids,
                     sample_idx, cfg: ModelConfig, *,
                     tp: TensorParallel | None = None):
    """ONE step over a packed ragged token batch: prefill chunks, decode
    rows and speculative verify rows share the dispatch.

    tokens (T,) int32 packed tokens; positions (T,) int32 absolute positions
    (-1 = pad lane); row_ids (T,) int32 block-table row per token (-1 =
    pad); block_tables (R, nb) int32; sample_idx (R,) or (R, J): the packed
    lanes whose logits each request row samples from.  Returns f32 logits
    (R, V) or (R, J, V); every layer's pool in ``pools`` is updated in
    place (all packed K/V is written before the layer's attention reads).

    ``tp``: a tensor-parallel slice; ``params`` and ``pools`` are then the
    shards' local trees (lists, in mesh order) and the logits land on the
    first shard's device.  Without it, one param tree and its pools run as
    a slice of one shard."""
    shards, local, tp = _one_shard(params, pools, tp)
    xs = _paged_layers(shards, local, tokens, positions, block_tables,
                       row_ids, cfg, tp)                 # (T, d) a device
    idx = {d: sample_idx.to(d, non_blocking=True).long() for d in xs}
    if sample_idx.dim() == 1:
        return _slice_head(shards, {d: xs[d][i] for d, i in idx.items()},
                           cfg, tp)
    # (R, J): one head product per fed position j, each of R rows, so a
    # row's logits at position 0 do not depend on J (the product's shape
    # stays (R, d) x (d, V) whatever the number of verified drafts)
    return torch.stack([_slice_head(shards, {d: xs[d][i[:, j]] for d, i in
                                             idx.items()}, cfg, tp)
                        for j in range(sample_idx.shape[1])], dim=1)
