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
  (``kernels/decode_attention/ops.py::ragged_paged_attention``).

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

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import quant as da_quant
from repro_torch.kernels.flash_attention import ops as fa_ops

from .config import LayerSpec, ModelConfig
from .layers import dense_init, dtype_of, rmsnorm, rmsnorm_init, rope


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


# ------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
               *, device) -> dict:
    """One layer's dense decode cache: S_c = max_len slots, or a ring of
    min(window, max_len) for a windowed layer; every slot empty (-1)."""
    S_c = min(spec.window, max_len) if spec.window else max_len
    shape = (batch, S_c, cfg.n_kv_heads, cfg.head_dim)
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
    q = (x @ params["wq"].reshape(d, -1)).reshape(*lead, cfg.n_heads, -1)
    k = (x @ params["wk"].reshape(d, -1)).reshape(*lead, cfg.n_kv_heads, -1)
    v = (x @ params["wv"].reshape(d, -1)).reshape(*lead, cfg.n_kv_heads, -1)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q = rope(q, positions, spec.rope_theta)
    k = rope(k, positions, spec.rope_theta)
    return q, k, v


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
              cfg: ModelConfig, spec: LayerSpec,
              cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """x (B, T, d), positions (B, T).  Returns (y (B, T, d), cache).

    Without a cache: causal self-attention over whole sequences (train /
    scoring) through K2, which ignores ``positions`` and attends over
    0..T-1, as the JAX package's kernel does.

    With a dense cache (decode, T = 1): write this step's K/V into the cache
    in place, then attend over it through K4.  The JAX package also accepts
    T > 1 here, but no path of it passes more than one token (prefill goes
    through ``prefill_cache``), so that raises."""
    B, T, _ = x.shape
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
        _cache_write(cache, k, v, positions)
        out = da_ops.decode_attention(
            q[:, 0].contiguous(), cache["k"], cache["v"],
            positions[:, 0].contiguous(), cache["pos"], window=spec.window,
            softcap=cfg.attn_logit_softcap, scale=cfg.head_dim ** -0.5)
    return out.reshape(B, T, -1) @ params["wo"].reshape(-1, cfg.d_model), cache


def prefill_cache(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  cfg: ModelConfig, spec: LayerSpec, max_len: int
                  ) -> tuple[torch.Tensor, dict]:
    """Attention over the prompt (K2: positions 0..S-1, which the dense
    engine always passes) AND the layer's decode cache for ``max_len``
    positions.  The JAX package attends with its XLA path here
    (``_attend_chunked``), which computes the same function."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, positions, cfg=cfg, spec=spec)
    out = fa_ops.flash_attention(q, k, v, positions=positions,
                                 window=spec.window,
                                 softcap=cfg.attn_logit_softcap,
                                 scale=cfg.head_dim ** -0.5)
    cache = init_cache(cfg, spec, B, max_len, device=x.device)
    _cache_write(cache, k, v, positions)
    return out.reshape(B, S, -1) @ params["wo"].reshape(-1, cfg.d_model), cache


def paged_attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    *, cfg: ModelConfig, spec: LayerSpec, pool: dict,
                    block_table: torch.Tensor,
                    row_ids: torch.Tensor) -> torch.Tensor:
    """Ragged-mode attention against the paged pool: x (T, d) is ONE packed
    row of mixed prefill-chunk, decode and verify tokens; token t belongs to
    request row ``row_ids[t]`` of ``block_table`` (-1 = pad lane).  Writes
    all packed K/V into ``pool`` first, then every token attends causally at
    its own position.  Returns (T, d)."""
    T = x.shape[0]
    q, k, v = _qkv(params, x, positions, cfg=cfg, spec=spec)
    _ragged_paged_write(pool, k, v, positions, block_table, row_ids)
    out = da_ops.ragged_paged_attention(
        q, pool["k"], pool["v"], block_table, row_ids, positions,
        k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"),
        window=spec.window, softcap=cfg.attn_logit_softcap,
        scale=cfg.head_dim ** -0.5)
    return out.reshape(T, -1) @ params["wo"].reshape(-1, cfg.d_model)
