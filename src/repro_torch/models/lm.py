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
the phase-separated steps over it (attention through K1 in all three).  One block body
(``_apply_block``) serves them all.  The JAX package scans each segment over
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

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.tree import named_leaves, tree_map

from . import attention as attn_mod
from . import mamba2 as mamba_mod
from .config import LayerSpec, ModelConfig
from .layers import (dtype_of, embed_init, embed_lookup, rmsnorm,
                     rmsnorm_init, softcap, unembed)
from .mlp import mlp, mlp_init
from .moe import moe, moe_init

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
    generators differ."""
    _check_ported(cfg)
    if generator is None:
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
        isinstance(node[0], torch.Tensor)
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
def _embed_inputs(params, inputs, cfg: ModelConfig):
    """(B, S, d) activations: token ids looked up (and scaled, where the
    config says so), or a frontend's embeddings cast to the model's dtype,
    with no lookup and no scale, as in the JAX package."""
    if cfg.input_mode == "embeds":
        return inputs.to(dtype_of(cfg))
    return embed_lookup(params["embed"], inputs, scale=cfg.embed_scale,
                        d=cfg.d_model)


def _head(params, x, cfg: ModelConfig):
    """Final norm + unembed (f32 logits) + final softcap."""
    x = rmsnorm(params["final_norm"], x)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return softcap(unembed(table, x), cfg.final_logit_softcap)


def _attend(p, h, positions, *, cfg, spec, mode, cache, max_len):
    """The attention of an attn_mlp or shared_attn layer in ``mode``:
    (y, the layer's cache)."""
    if mode == "prefill":
        return attn_mod.prefill_cache(p, h, positions, cfg=cfg, spec=spec,
                                      max_len=max_len)
    return attn_mod.attention(p, h, positions, cfg=cfg, spec=spec,
                              cache=cache)


def _apply_block(p, x, positions, *, cfg: ModelConfig, spec: LayerSpec,
                 mode: str = "score", cache=None, shared=None, embeds0=None,
                 max_len: int | None = None, pool=None, block_table=None,
                 row_ids=None):
    """One layer.  Returns (x, the layer's new cache or None, the MoE aux
    loss of an attn_moe layer or None).

    ``mode`` is "score" (whole sequences x (B, T, d), no cache), "prefill"
    (builds the layer's dense cache for ``max_len`` positions; a mamba layer
    starts from ``cache``'s state), "decode" (one token per row against
    ``cache``), or "paged" (against ``pool``, updated in place; attn_mlp
    and attn_moe layers only): the packed row x (T, d) with ``row_ids``, or
    x (B, T, d) with ``row_ids`` None, row b on ``block_table`` row b.
    ``shared`` holds zamba2's shared-attention parameters, ``embeds0`` the
    stack's input embeddings that its block reads beside the hidden
    state."""
    if spec.kind == "mamba":
        y, new_cache = mamba_mod.mamba_block(p["mamba"], rmsnorm(p["norm"], x),
                                             cfg=cfg, cache=cache)
        return x + y, new_cache, None

    if spec.kind == "shared_attn":
        u = torch.cat([x, embeds0], dim=-1)
        y, new_cache = _attend(shared["attn"], rmsnorm(shared["norm_attn"], u),
                               positions, cfg=cfg, spec=spec, mode=mode,
                               cache=cache, max_len=max_len)
        x = x + y
        v = torch.cat([x, embeds0], dim=-1)
        return (x + mlp(shared["mlp"], rmsnorm(shared["norm_mlp"], v)),
                new_cache, None)

    h = rmsnorm(p["norm_attn"], x)
    if mode == "paged":
        y = attn_mod.paged_attention(p["attn"], h, positions, cfg=cfg,
                                     spec=spec, pool=pool,
                                     block_table=block_table, row_ids=row_ids)
        new_cache = None
    else:
        y, new_cache = _attend(p["attn"], h, positions, cfg=cfg, spec=spec,
                               mode=mode, cache=cache, max_len=max_len)
    if cfg.post_norm:
        y = rmsnorm(p["post_norm_attn"], y)
    x = x + y
    h = rmsnorm(p["norm_mlp"], x)
    aux = None
    if spec.kind == "attn_moe":
        y, aux = moe(p["moe"], h, cfg=cfg)
    else:
        y = mlp(p["mlp"], h)
    if cfg.post_norm:
        y = rmsnorm(p["post_norm_mlp"], y)
    return x + y, new_cache, aux


def _copies(cfg: ModelConfig):
    """(first layer, pattern) of every pattern copy, in layer order: the
    bodies of the JAX package's scans over each segment's repeat axis."""
    li = 0
    for seg in cfg.layout():
        for _ in range(seg.repeat):
            yield li, seg.pattern
            li += len(seg.pattern)


def forward(params, inputs, positions, cfg: ModelConfig, *,
            mode: str = "score"):
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
    The kernels' gradients are their plain versions' (see their wrappers)."""
    _check_ported(cfg)
    if mode not in ("score", "train"):
        raise ValueError(f"mode must be 'score' or 'train', got {mode!r}")
    x = _embed_inputs(params, inputs, cfg)                     # (B, S, d)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared_attn")
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()

    def run_copy(layers, pattern, x, aux, embeds0):
        for spec, p in zip(pattern, layers):
            x, _, layer_aux = _apply_block(p, x, positions, cfg=cfg,
                                           spec=spec, shared=shared,
                                           embeds0=embeds0)
            if layer_aux is not None:
                aux = aux + layer_aux
        return x, aux

    embeds0 = x
    for li, pattern in _copies(cfg):
        layers = params["layers"][li:li + len(pattern)]
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                run_copy, layers, pattern, x, aux, embeds0,
                use_reentrant=False)
        else:
            x, aux = run_copy(layers, pattern, x, aux, embeds0)
    return _head(params, x, cfg), aux


def prefill(params, inputs, positions, cfg: ModelConfig, *, max_len: int):
    """Run the prompt and build the dense decode caches: inputs (B, S)
    int32 tokens or (B, S, d) embeddings, positions (B, S) int32 (0..S-1,
    as the dense engine passes them).  Returns (f32 last-token logits (B, V), caches: one dict
    per layer, each for ``max_len`` positions)."""
    _check_ported(cfg)
    x = _embed_inputs(params, inputs, cfg)
    embeds0 = x
    caches = []
    for spec, p in zip(layer_specs(cfg), params["layers"]):
        start = (mamba_mod.mamba_cache_init(cfg, x.shape[0], device=x.device)
                 if spec.kind == "mamba" else None)
        x, nc, _ = _apply_block(p, x, positions, cfg=cfg, spec=spec,
                                mode="prefill", cache=start,
                                shared=params.get("shared_attn"),
                                embeds0=embeds0, max_len=max_len)
        caches.append(nc)
    return _head(params, x[:, -1:, :], cfg)[:, 0, :], caches


def decode_step(params, caches, inputs, positions, cfg: ModelConfig):
    """One decode step: inputs (B,) or (B, 1) int32 tokens, or (B, 1, d)
    embeddings, positions (B, 1) int32.  Returns (f32 logits (B, V),
    caches).  ``caches`` (one dict per layer, from ``prefill`` or
    ``init_decode_caches``) is updated in place, where the JAX package
    returns new trees."""
    if cfg.input_mode == "tokens" and inputs.dim() == 1:
        inputs = inputs[:, None]
    x = _embed_inputs(params, inputs, cfg)
    embeds0 = x
    for spec, p, cache in zip(layer_specs(cfg), params["layers"], caches):
        x, nc, _ = _apply_block(p, x, positions, cfg=cfg, spec=spec,
                                mode="decode", cache=cache,
                                shared=params.get("shared_attn"),
                                embeds0=embeds0)
        if spec.kind == "mamba":
            for k, leaf in nc.items():
                cache[k].copy_(leaf)
    return _head(params, x, cfg)[:, 0, :], caches


def _paged_layers(params, pools, x, positions, block_tables, row_ids, cfg):
    for spec, p, pool in zip(layer_specs(cfg), params["layers"], pools):
        x, _, _ = _apply_block(p, x, positions, cfg=cfg, spec=spec,
                               mode="paged", pool=pool,
                               block_table=block_tables, row_ids=row_ids)
    return x


def paged_prefill(params, pools, block_tables, inputs, positions,
                  cfg: ModelConfig):
    """Prefill a (possibly block-aligned-truncated) prompt suffix against
    the paged pool: inputs (B, T) int32 suffix tokens, positions (B, T)
    int32 their absolute positions (row b starts at its reused prefix
    length), row b on ``block_tables`` row b.  The suffix attends to the
    reused prefix KV through the table without recomputing it (K1, its
    B·T tokens packed as lanes of rows 0..B-1).  Returns (f32 last-token
    logits (B, V), pools), the pools updated in place."""
    x = _paged_layers(params, pools, _embed_inputs(params, inputs, cfg),
                      positions, block_tables, None, cfg)
    return _head(params, x[:, -1:, :], cfg)[:, 0, :], pools


def paged_decode_step(params, pools, block_tables, inputs, positions,
                      cfg: ModelConfig):
    """One decode step over the paged pool: inputs (B,) or (B, 1) int32
    tokens, positions (B, 1) int32 (K1 with one token per row).  Returns
    (f32 logits (B, V), pools), the pools updated in place."""
    if inputs.dim() == 1:
        inputs = inputs[:, None]
    x = _paged_layers(params, pools, _embed_inputs(params, inputs, cfg),
                      positions, block_tables, None, cfg)
    return _head(params, x, cfg)[:, 0, :], pools


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
    x = _paged_layers(params, pools, _embed_inputs(params, tokens, cfg),
                      positions, block_tables, row_ids, cfg)   # (T, d)
    if sample_idx.dim() == 1:
        return _head(params, x[sample_idx.long()], cfg)
    # (R, J): one head product per fed position j, each of R rows, so a
    # row's logits at position 0 do not depend on J (the product's shape
    # stays (R, d) x (d, V) whatever the number of verified drafts)
    return torch.stack([_head(params, x[sample_idx[:, j].long()], cfg)
                        for j in range(sample_idx.shape[1])], dim=1)
