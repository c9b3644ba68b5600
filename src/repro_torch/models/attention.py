"""GQA attention: the full-sequence forward, the dense per-slot decode
caches and the paged KV block pool.

Port of the JAX package's ``models/attention.py``: the QKV projections and
RoPE, then one of

- ``attention`` without a cache: causal self-attention over a whole
  sequence through the K2 wrapper (``kernels/flash_attention/ops.py``);
- ``prefill_cache``: the same over a prompt (K2), which also builds the
  layer's dense decode cache;
- ``attention`` with a dense cache and one new token per row: write the
  token's K/V, then attend over the cache through the K4 wrapper
  (``kernels/decode_attention/ops.py::decode_attention``);
- ``paged_attention``: the pool layout, quantize-on-write and the packed
  ragged write, then ragged paged attention through the K1 wrapper
  (``kernels/decode_attention/ops.py::ragged_paged_attention``), for one
  packed row (the engine's tick) or a (B, T) batch (the phase-separated
  paged prefill and decode steps).

Each wrapper launches the hand-written CUDA kernel for CUDA tensors and runs
its plain version for CPU tensors.

Dense cache layout (as in the JAX package): ``{"k": (B, S_c, K, D), "v":
(B, S_c, K, D), "pos": (B, S_c)}``, ``pos`` the absolute position in each
slot (-1 = empty); windowed layers keep a ring of S_c = window slots.

Caches and the pool are updated IN PLACE (``index_put_``): this is the
port's counterpart of the JAX engine donating them to its jitted step, and
it saves a copy of every cache per decode step.  Every packed token's K/V
is written before the layer's attention reads, so a chunk token sees its
same-dispatch predecessors and a same-tick sibling's shared prefix blocks.
"""
from __future__ import annotations

import torch

from repro_torch.core.sharded import record_collective
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import quant as da_quant
from repro_torch.kernels.flash_attention import ops as fa_ops

from . import slices
from .config import LayerSpec, ModelConfig
from .layers import (dense_init, dtype_of, matmul_f32, rmsnorm, rmsnorm_axes,
                     rmsnorm_init, rope)


# ------------------------------------------------------------------ params
def attn_init(generator: torch.Generator, cfg: ModelConfig, device, *,
              d_in: int | None = None, d_out: int | None = None) -> dict:
    """``d_in``/``d_out`` default to d_model; zamba2's shared block reads
    concat(hidden, embeddings), 2·d_model wide."""
    d_in, d_out = d_in or cfg.d_model, d_out or cfg.d_model
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(generator, (d_in, H, D), dt, device),
        "wk": dense_init(generator, (d_in, K, D), dt, device),
        "wv": dense_init(generator, (d_in, K, D), dt, device),
        "wo": dense_init(generator, (H, D, d_out), dt, device, in_axis=0),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(D, device)
        p["k_norm"] = rmsnorm_init(D, device)
    return p


def attn_axes(cfg: ModelConfig) -> dict:
    p = {"wq": ("embed", "heads", None),
         "wk": ("embed", "kv_heads", None),
         "wv": ("embed", "kv_heads", None),
         "wo": ("heads", None, "embed")}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_axes()
        p["k_norm"] = rmsnorm_axes()
    return p


# ------------------------------------------------------------------- cache
def cache_axes() -> dict:
    return {"k": ("cache_batch", "cache_seq", "kv_heads", None),
            "v": ("cache_batch", "cache_seq", "kv_heads", None),
            "pos": ("cache_batch", "cache_seq")}


def init_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
               *, device, kv_heads: int | None = None) -> dict:
    """One layer's dense decode cache: S_c = max_len slots, or a ring of
    min(window, max_len) for a windowed layer; every slot empty (-1).
    ``kv_heads`` defaults to the config's (a shard's split cache holds
    fewer)."""
    S_c = min(spec.window, max_len) if spec.window else max_len
    shape = (batch, S_c, kv_heads or cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "pos": torch.full((batch, S_c), -1, dtype=torch.int32,
                              device=device)}


def _cache_write(cache: dict, k_new, v_new, positions) -> None:
    """Write T new entries per row at slots ``positions % S_c``, in place.

    A prompt longer than a ring (T > S_c) would write some slots twice, and
    which duplicate ``index_put_`` keeps is unspecified on CUDA; only the
    last S_c positions are written, which leaves the ring as the JAX
    package's in-order scatter does (the last write of each slot wins)."""
    B, S_c = cache["pos"].shape
    if positions.shape[1] > S_c:
        k_new, v_new = k_new[:, -S_c:], v_new[:, -S_c:]
        positions = positions[:, -S_c:]
    slots = (positions % S_c).long()
    bidx = torch.arange(B, device=slots.device)[:, None]
    cache["k"][bidx, slots] = k_new.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions.to(torch.int32)


def _seq_write(parts: list, k_new, v_new, positions, S_c: int) -> None:
    """Write each row's one new entry into the part of a cache split over
    the sequence (``parts``: the parts held here, from the first, each of
    S_c / group slots) that holds its slot ``positions % S_c``, in place;
    every other part's slot keeps its contents."""
    S_p = parts[0]["pos"].shape[1]
    bidx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    slot = (positions % S_c).long()
    for i, part in enumerate(parts):
        local = slot - i * S_p
        own = (local >= 0) & (local < S_p)
        local = local.clamp(0, S_p - 1)
        for name, new in (("k", k_new), ("v", v_new), ("pos", positions)):
            leaf = part[name]
            old = leaf[bidx, local]
            keep = own.reshape(own.shape + (1,) * (old.dim() - 2))
            leaf[bidx, local] = torch.where(keep, new.to(leaf.dtype), old)


def _seq_merge(outs: list, lses: list, seq: tuple, dtype) -> torch.Tensor:
    """The attention over the whole sequence from each part's output and
    log-sum-exp (K4's), merged in part order with f32 weights
    exp(lse - max); the parts held elsewhere (the dry run runs one on
    meta) stand in by the first's shape (``slices.tiled``).  An all-gather
    of (out, lse) over the sequence group ``seq`` = (group size, its
    stride in mesh order)."""
    group, stride = seq
    outs, lses = slices.tiled(outs, group), slices.tiled(lses, group)
    top = torch.stack(lses).amax(dim=0)
    num = den = None
    for o, l in zip(outs, lses):
        w = torch.exp(l - top)
        part = w[..., None] * o.float()
        num = part if num is None else num + part
        den = w if den is None else den + w
    B, H, D = outs[0].shape
    record_collective("all-gather", group * B * H * (D + 1) * 4, group,
                      stride)
    return (num / den[..., None]).to(dtype)


# ------------------------------------------------------------------ paging
def init_paged_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
                    kv_dtype: str | None = None, *, device) -> dict:
    """One layer's share of the global KV block pool: (num_blocks,
    block_size, K, D) K/V leaves; int8 / fp8_e4m3 add f32 ``k_scale`` /
    ``v_scale`` leaves (num_blocks, block_size, K), initialised to 1 so
    untouched blocks (the reserved null block too) dequantize to zeros."""
    K, D = cfg.n_kv_heads, cfg.head_dim
    kv_dtype = cfg.kv_dtype if kv_dtype is None else kv_dtype
    dt = da_quant.storage_dtype(kv_dtype, dtype_of(cfg))
    shape = (num_blocks, block_size, K, D)
    pool = {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
    if da_quant.is_quantized(kv_dtype):
        pool["k_scale"] = torch.ones(shape[:3], dtype=torch.float32,
                                     device=device)
        pool["v_scale"] = torch.ones(shape[:3], dtype=torch.float32,
                                     device=device)
    return pool


def paged_pool_axes(cfg: ModelConfig, kv_dtype: str | None = None) -> dict:
    """Logical axes of one layer's pool leaves (mirrors ``init_paged_pool``):
    the block and slot dims stay unsharded (block tables are host-side and
    every shard scatters any (block, slot)), so ``kv_heads`` is the one
    shardable dim, the attention weights' split; scale leaves carry the
    same (block, slot, kv-head) layout less the head_dim."""
    kv_dtype = cfg.kv_dtype if kv_dtype is None else kv_dtype
    kv = (None, None, "kv_heads", None)
    axes = {"k": kv, "v": kv}
    if da_quant.is_quantized(kv_dtype):
        axes["k_scale"] = (None, None, "kv_heads")
        axes["v_scale"] = (None, None, "kv_heads")
    return axes


def _quantize_for_pool(pool: dict, k_new, v_new):
    """Quantize new K/V entries to the pool's storage dtype (identity for
    unquantized pools); per-token-per-head scales."""
    if "k_scale" not in pool:
        return k_new, v_new, None, None
    name = "int8" if pool["k"].dtype == torch.int8 else "fp8_e4m3"
    kq, ks = da_quant.quantize_kv(k_new, name)
    vq, vs = da_quant.quantize_kv(v_new, name)
    return kq, vq, ks, vs


def _ragged_paged_write(pool: dict, k_new, v_new, positions, block_table,
                        row_ids) -> None:
    """Scatter a PACKED token batch's K/V into pool blocks, in place: token
    t lands in its own request's block, resolved through ``row_ids``.

    k_new/v_new: (T,K,D); positions (T,) absolute (-1 = pad); block_table
    (R,nb); row_ids (T,) request row per token (-1 = pad).  Pad lanes all
    land on block 0, slot 0 (the reserved null block); with duplicate
    indices that slot's contents are unspecified, as in the reference."""
    bs = pool["k"].shape[1]
    rows = row_ids.clamp(0, block_table.shape[0] - 1).long()
    posc = positions.clamp(min=0).long()
    blk = block_table[rows, posc // bs].long()
    valid = (row_ids >= 0) & (positions >= 0)
    zero = torch.zeros_like(blk)
    blk = torch.where(valid, blk.clamp(min=0), zero)
    slot = torch.where(valid, posc % bs, zero)
    k_new, v_new, ks, vs = _quantize_for_pool(pool, k_new, v_new)
    pool["k"].index_put_((blk, slot), k_new.to(pool["k"].dtype))
    pool["v"].index_put_((blk, slot), v_new.to(pool["v"].dtype))
    if ks is not None:
        pool["k_scale"].index_put_((blk, slot), ks)
        pool["v_scale"].index_put_((blk, slot), vs)


# ------------------------------------------------------------------- apply
def _qkv(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
         cfg: ModelConfig, spec: LayerSpec):
    """Projection + qk-norm + RoPE.  x (..., T, d), positions (..., T) →
    q (..., T, H, D), k/v (..., T, K, D)."""
    *lead, d = x.shape
    # heads from the weights: a tensor-parallel shard holds a slice of them
    q = (x @ params["wq"].reshape(d, -1)).reshape(*lead, -1, cfg.head_dim)
    k = (x @ params["wk"].reshape(d, -1)).reshape(*lead, -1, cfg.head_dim)
    v = (x @ params["wv"].reshape(d, -1)).reshape(*lead, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q = rope(q, positions, spec.rope_theta)
    k = rope(k, positions, spec.rope_theta)
    return q, k, v


def _out(params: dict, out: torch.Tensor, lead, cfg: ModelConfig,
         partial: bool) -> torch.Tensor:
    """The ``wo`` product of the attention output; ``partial``: a shard's
    unrounded f32 share (``layers.matmul_f32``)."""
    wo = params["wo"].reshape(-1, cfg.d_model)
    out = out.reshape(*lead, -1)
    return matmul_f32(out, wo) if partial else out @ wo


def _kv_cut(t: torch.Tensor, kv_heads) -> torch.Tensor:
    """The kv heads (k0, k1) of a (..., K, D) tensor, contiguous (the
    kernels take contiguous operands)."""
    if kv_heads is None:
        return t
    return t[..., kv_heads[0]:kv_heads[1], :].contiguous()


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
              cfg: ModelConfig, spec: LayerSpec,
              cache: dict | list | None = None,
              kv_heads: tuple | None = None, partial: bool = False,
              seq: tuple | None = None) -> tuple[torch.Tensor, dict | None]:
    """x (B, T, d), positions (B, T).  Returns (y (B, T, d), cache).

    Without a cache: causal self-attention over whole sequences (train /
    scoring) through K2, which ignores ``positions`` and attends over
    0..T-1, as the JAX package's kernel does.

    With a dense cache (decode, T = 1): write this step's K/V into the cache
    in place, then attend over it through K4.  The JAX package also accepts
    T > 1 here, but no path of it passes more than one token (prefill goes
    through ``prefill_cache``), so that raises.

    A tensor-parallel shard passes its slice of the heads in ``params``;
    ``kv_heads`` (k0, k1) is the range of replicated kv heads its q heads
    read (without a cache only those are projected; a replicated cache is
    written whole and read in that range), and ``partial`` returns its
    unrounded f32 share of the ``wo`` product.

    A cache split over the sequence (``seq`` = (group, stride): a list of
    the parts held here) takes the new entry in the part that holds its
    slot; each part attends through K4, which also returns its
    log-sum-exp, and the parts' outputs merge by it (``_seq_merge``)."""
    B, T, _ = x.shape
    if cache is None and kv_heads is not None:
        k0, k1 = kv_heads
        params = dict(params, wk=params["wk"][:, k0:k1],
                      wv=params["wv"][:, k0:k1])
        kv_heads = None
    q, k, v = _qkv(params, x, positions, cfg=cfg, spec=spec)
    if cache is None:
        out = fa_ops.flash_attention(q, k, v, positions=positions,
                                     window=spec.window,
                                     softcap=cfg.attn_logit_softcap,
                                     scale=cfg.head_dim ** -0.5)
    else:
        if T != 1:
            raise NotImplementedError(
                f"attention over a dense cache with T = {T} > 1 new tokens "
                f"is on no path of the JAX package (its prefill builds the "
                f"cache with prefill_cache)")
        kw = dict(window=spec.window, softcap=cfg.attn_logit_softcap,
                  scale=cfg.head_dim ** -0.5)
        parts = cache if seq is not None else [cache]
        if seq is not None:
            _seq_write(parts, k, v, positions,
                       parts[0]["pos"].shape[1] * seq[0])
        else:
            _cache_write(cache, k, v, positions)
        res = [da_ops.decode_attention(
            q[:, 0].contiguous(), _kv_cut(p["k"], kv_heads),
            _kv_cut(p["v"], kv_heads), positions[:, 0].contiguous(),
            p["pos"], lse=seq is not None, **kw) for p in parts]
        out = res[0] if seq is None else _seq_merge(
            [r[0] for r in res], [r[1] for r in res], seq, q.dtype)
    return _out(params, out, (B, T), cfg, partial), cache


def prefill_cache(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  cfg: ModelConfig, spec: LayerSpec, max_len: int,
                  kv_heads: tuple | None = None, partial: bool = False
                  ) -> tuple[torch.Tensor, dict]:
    """Attention over the prompt (K2: positions 0..S-1, which the dense
    engine always passes) AND the layer's decode cache for ``max_len``
    positions, of the kv heads the weights hold.  The JAX package attends
    with its XLA path here (``_attend_chunked``), which computes the same
    function.  ``kv_heads`` and ``partial``: as in ``attention`` (the
    cache holds every kv head; K2 reads the range)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, positions, cfg=cfg, spec=spec)
    out = fa_ops.flash_attention(q, _kv_cut(k, kv_heads),
                                 _kv_cut(v, kv_heads), positions=positions,
                                 window=spec.window,
                                 softcap=cfg.attn_logit_softcap,
                                 scale=cfg.head_dim ** -0.5)
    cache = init_cache(cfg, spec, B, max_len, device=x.device,
                       kv_heads=k.shape[2])
    _cache_write(cache, k, v, positions)
    return _out(params, out, (B, S), cfg, partial), cache


def paged_attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    *, cfg: ModelConfig, spec: LayerSpec, pool: dict,
                    block_table: torch.Tensor,
                    row_ids: torch.Tensor | None = None,
                    kv_heads: tuple[int, int] | None = None,
                    partial: bool = False) -> torch.Tensor:
    """Attention against the paged pool, through K1 in both modes.  Writes
    the new tokens' K/V into ``pool`` first (in place), then every token
    attends causally at its own position over everything its row's block
    table maps, shared prefix blocks included.

    Ragged mode (``row_ids`` given): x (T, d) is ONE packed row of mixed
    prefill-chunk, decode and verify tokens; token t belongs to request row
    ``row_ids[t]`` of ``block_table`` (-1 = pad lane).  Returns (T, d).

    Batched mode (``row_ids`` None): x (B, T, d), positions (B, T), row b
    on ``block_table`` row b.  A decode step (T = 1) is K1's one-token
    packing (``ops.paged_decode_attention``); a suffix prefill (T > 1)
    packs the B·T tokens as lanes of rows 0..B-1.  The JAX package runs
    both through its XLA gather + masked softmax, which computes the same
    function.  Returns (B, T, d).

    A tensor-parallel shard passes its slice of the heads in ``params``;
    ``kv_heads`` (k0, k1) is the range of a replicated pool's kv heads that
    its q heads read (K1 reads that slice of the pool in place), and
    ``partial`` returns its unrounded f32 share of the ``wo`` product
    (``layers.matmul_f32``), summed over the shards by the caller."""
    lead = x.shape[:-1]
    q, k, v = _qkv(params, x, positions, cfg=cfg, spec=spec)
    cut = (lambda t: t) if kv_heads is None else \
        (lambda t: t[:, :, kv_heads[0]:kv_heads[1]])
    kw = dict(k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"),
              window=spec.window, softcap=cfg.attn_logit_softcap,
              scale=cfg.head_dim ** -0.5)
    if kw["k_scale"] is not None:
        kw.update(k_scale=cut(kw["k_scale"]), v_scale=cut(kw["v_scale"]))
    if row_ids is None:
        B, T = lead
        rows = torch.arange(B, dtype=torch.int32, device=x.device)
        row_ids = rows.repeat_interleave(T)
        q, k, v = (t.reshape(B * T, *t.shape[2:]) for t in (q, k, v))
        positions = positions.reshape(B * T).to(torch.int32)
    _ragged_paged_write(pool, k, v, positions, block_table, row_ids)
    k_pool, v_pool = cut(pool["k"]), cut(pool["v"])
    if len(lead) == 2 and lead[1] == 1:
        out = da_ops.paged_decode_attention(q, k_pool, v_pool, block_table,
                                            positions, **kw)
    else:
        out = da_ops.ragged_paged_attention(q, k_pool, v_pool, block_table,
                                            row_ids, positions, **kw)
    wo = params["wo"].reshape(-1, cfg.d_model)
    if partial:
        return matmul_f32(out.reshape(*lead, -1), wo)
    return out.reshape(*lead, -1) @ wo
