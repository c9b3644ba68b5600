"""Decoder LM over the segment/pattern layout: the full-sequence forward
and the paged serving step.

Port of the JAX package's ``models/lm.py`` for pure-attention token models
(``supports_paged``).  ``forward`` scores whole sequences (attention through
K2, the flash-attention kernel); ``paged_mixed_step`` runs one packed tick
against the paged KV pool (attention through K1).  One block body
(``_apply_block``) serves both.  The JAX package scans each segment over
``repeat`` stacked parameter copies; the port keeps one flat list of layers
in the same order (``layer_specs``): layer ``r·len(pattern) + i`` of a
segment is pattern position ``i`` of copy ``r``.  For gemma2 (``Segment((local,
global), 21)``) even layers are local (windowed) and odd layers global —
``params_from_numpy`` and ``pools_from_numpy`` unstack in exactly that
order.

Params: ``{"embed": {"table"}, "final_norm": {"scale"}, "layers": [layer
dict, ...]}`` (+ ``"head"`` for untied embeddings); each layer dict has the
JAX leaf names and layouts.  Pools: a list with one dict per layer, updated
in place by ``paged_mixed_step``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import attention as attn_mod
from .config import LayerSpec, ModelConfig
from .layers import (dtype_of, embed_init, embed_lookup, rmsnorm,
                     rmsnorm_init, softcap, unembed)
from .mlp import mlp, mlp_init


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """The flat layer order of the stack (segment, then copy, then pattern
    position) — the order of ``params["layers"]`` and of the pools."""
    return [spec for seg in cfg.layout() for _ in range(seg.repeat)
            for spec in seg.pattern]


def supports_paged(cfg: ModelConfig) -> bool:
    """Paged KV serving needs token inputs (the prefix trie is keyed by
    token blocks) and pure-attention layers."""
    return cfg.input_mode == "tokens" and all(
        s.kind in ("attn_mlp", "attn_moe")
        for seg in cfg.layout() for s in seg.pattern)


def supports_speculative(cfg: ModelConfig) -> bool:
    """Multi-token verify rows and their KV rollback need the paged path."""
    return supports_paged(cfg)


def _check_ported(cfg: ModelConfig) -> None:
    kinds = {s.kind for s in layer_specs(cfg)}
    if not supports_paged(cfg) or kinds != {"attn_mlp"}:
        raise NotImplementedError(
            f"config {cfg.name}: the port runs token models of attn_mlp "
            f"layers only; {sorted(kinds)} / input_mode={cfg.input_mode!r} "
            f"join with the dense/SSM and MoE slices")


# ====================================================================== init
def _block_init(generator, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    p = {"norm_attn": rmsnorm_init(d, device),
         "attn": attn_mod.attn_init(generator, cfg, device),
         "norm_mlp": rmsnorm_init(d, device)}
    if cfg.post_norm:
        p["post_norm_attn"] = rmsnorm_init(d, device)
        p["post_norm_mlp"] = rmsnorm_init(d, device)
    p["mlp"] = mlp_init(generator, cfg, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Seeded random weights, made directly on ``device``.  Same
    distributions as the JAX initialisers (N(0,1) embedding table, dense
    weights N(0, 1/fan_in), zero norm scales); the draws differ, since the
    two frameworks' generators differ."""
    _check_ported(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = dtype_of(cfg)
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
        "layers": [_block_init(generator, cfg, device)
                   for _ in layer_specs(cfg)],
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(generator, cfg.vocab_size, cfg.d_model,
                                    dt, device)
    return params


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
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(segments, cfg: ModelConfig, fn) -> list:
    """Per-layer trees, in ``layer_specs`` order, from the JAX package's
    tuple (segment) of tuples (pattern position) of stacked trees."""
    out = []
    for seg, seg_tree in zip(cfg.layout(), segments):
        for r in range(seg.repeat):
            for i in range(len(seg.pattern)):
                out.append(_map(seg_tree[i], lambda a, r=r: fn(a[r])))
    return out


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """The port's params from a JAX ``init_params`` tree after
    ``jax.tree.map(np.asarray, ...)``, unstacking each segment's ``repeat``
    axis into the flat layer order."""
    _check_ported(cfg)
    conv = lambda a: _to_torch(a, device)
    params = {"embed": _map(tree["embed"], conv),
              "final_norm": _map(tree["final_norm"], conv),
              "layers": _unstack(tree["segments"], cfg, conv)}
    if "head" in tree:
        params["head"] = _map(tree["head"], conv)
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
    out, li = [], 0
    for seg in cfg.layout():
        n = len(seg.pattern)
        per_pos = []
        for i in range(n):
            layers = [pools[li + r * n + i] for r in range(seg.repeat)]
            per_pos.append({k: np.stack([_to_numpy(p[k]) for p in layers])
                            for k in layers[0]})
        out.append(tuple(per_pos))
        li += seg.n_layers
    return tuple(out)


def init_paged_pools(cfg: ModelConfig, num_blocks: int, block_size: int,
                     kv_dtype: str | None = None, *,
                     device="cuda") -> list[dict]:
    """The global KV block pool: one dict per layer (``layer_specs`` order)
    of (num_blocks, block_size, K, D) leaves, plus scale leaves for int8 /
    fp8 pools (``kv_dtype`` defaults to ``cfg.kv_dtype``)."""
    _check_ported(cfg)
    return [attn_mod.init_paged_pool(cfg, num_blocks, block_size,
                                     kv_dtype=kv_dtype, device=device)
            for _ in layer_specs(cfg)]


# ==================================================================== blocks
def _embed_inputs(params, tokens, cfg: ModelConfig):
    return embed_lookup(params["embed"], tokens, scale=cfg.embed_scale,
                        d=cfg.d_model)


def _head(params, x, cfg: ModelConfig):
    """Final norm + unembed (f32 logits) + final softcap."""
    x = rmsnorm(params["final_norm"], x)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return softcap(unembed(table, x), cfg.final_logit_softcap)


def _apply_block(p, x, positions, *, cfg: ModelConfig, spec: LayerSpec,
                 pool=None, block_table=None, row_ids=None):
    """One attn_mlp layer: on whole sequences x (B, T, d) without a pool,
    or on the packed row x (T, d) against ``pool`` (updated in place)."""
    h = rmsnorm(p["norm_attn"], x)
    if pool is None:
        y, _ = attn_mod.attention(p["attn"], h, positions, cfg=cfg, spec=spec)
    else:
        y = attn_mod.paged_attention(p["attn"], h, positions, cfg=cfg,
                                     spec=spec, pool=pool,
                                     block_table=block_table, row_ids=row_ids)
    if cfg.post_norm:
        y = rmsnorm(p["post_norm_attn"], y)
    x = x + y
    y = mlp(p["mlp"], rmsnorm(p["norm_mlp"], x))
    if cfg.post_norm:
        y = rmsnorm(p["post_norm_mlp"], y)
    return x + y


def forward(params, inputs, positions, cfg: ModelConfig, *,
            mode: str = "score"):
    """Full-sequence forward (no caches): inputs (B, S) int32 tokens,
    positions (B, S) int32 (contiguous 0..S-1: K2 assumes them).  Returns
    (f32 logits (B, S, V), aux) with aux a zero f32 scalar (the MoE aux loss
    of attn_moe layers, which join with the MoE slice).

    ``mode="train"`` computes the same forward: the JAX package differs only
    by rematerialising blocks for its backward, and the port has no backward
    yet (the training slice)."""
    _check_ported(cfg)
    if mode not in ("score", "train"):
        raise ValueError(f"mode must be 'score' or 'train', got {mode!r}")
    x = _embed_inputs(params, inputs, cfg)                     # (B, S, d)
    for spec, p in zip(layer_specs(cfg), params["layers"]):
        x = _apply_block(p, x, positions, cfg=cfg, spec=spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg), aux


def paged_mixed_step(params, pools, block_tables, tokens, positions, row_ids,
                     sample_idx, cfg: ModelConfig):
    """ONE step over a packed ragged token batch: prefill chunks, decode
    rows and speculative verify rows share the dispatch.

    tokens (T,) int32 packed tokens; positions (T,) int32 absolute positions
    (-1 = pad lane); row_ids (T,) int32 block-table row per token (-1 =
    pad); block_tables (R, nb) int32; sample_idx (R,) or (R, J): the packed
    lanes whose logits each request row samples from.  Returns f32 logits
    (R, V) or (R, J, V); every layer's pool in ``pools`` is updated in
    place (all packed K/V is written before the layer's attention reads)."""
    x = _embed_inputs(params, tokens, cfg)                    # (T, d)
    for spec, p, pool in zip(layer_specs(cfg), params["layers"], pools):
        x = _apply_block(p, x, positions, cfg=cfg, spec=spec, pool=pool,
                         block_table=block_tables, row_ids=row_ids)
    if sample_idx.dim() == 1:
        return _head(params, x[sample_idx.long()], cfg)
    # (R, J): one head product per fed position j, each of R rows, so a
    # row's logits at position 0 do not depend on J (the product's shape
    # stays (R, d) x (d, V) whatever the number of verified drafts)
    return torch.stack([_head(params, x[sample_idx[:, j].long()], cfg)
                        for j in range(sample_idx.shape[1])], dim=1)
