"""Plain PyTorch versions of the decode-attention kernels (port of the JAX
package's ``kernels/decode_attention/ref.py`` oracles): the ragged paged
attention of K1 and the dense one-token decode attention of K4.

The CPU tests run them, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card; the served paths on the card never call them.  The ragged
version gathers one request row at a time (not one densified cache per
token), so it also runs at the serving shapes: the largest buffers are one
row's (L, K, D) cache and its (tokens, K, G, L) scores.
"""
from __future__ import annotations

import torch

from .quant import dequantize_kv

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, q_pos, cache_pos, *,
                         window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None):
    """One new token per row against its dense cache.  q: (B,H,D);
    k_cache/v_cache: (B,S,K,D); cache_pos: (B,S) absolute position of each
    slot (-1 empty); q_pos: (B,) the new token's position.  Slot s is
    visible iff 0 <= cache_pos <= q_pos (and q_pos - cache_pos < window), so
    ring buffers and partly filled rows need nothing else.  Scores in f32,
    tanh softcap after the scale, f32 softmax (a row with nothing visible
    averages its S values uniformly).  Returns (B,H,D) in q's dtype."""
    B, H, D = q.shape
    K = k_cache.shape[2]
    scale = D ** -0.5 if scale is None else scale
    qh = q.reshape(B, K, H // K, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = (cache_pos >= 0) & (cache_pos <= q_pos[:, None])
    if window is not None:
        mask &= (q_pos[:, None] - cache_pos) < window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_quant_ref(q, k_cache, v_cache, k_scale, v_scale, q_pos,
                               cache_pos, *, window: int | None = None,
                               softcap: float | None = None,
                               scale: float | None = None):
    """Quantized-cache version: int8 / fp8 caches with (B,S,K) f32 scales
    are dequantized, then the dense version runs."""
    return decode_attention_ref(
        q, dequantize_kv(k_cache, k_scale), dequantize_kv(v_cache, v_scale),
        q_pos, cache_pos, window=window, softcap=softcap, scale=scale)


def densify_pool(k_pool, v_pool, block_tables):
    """Gather a paged pool into dense per-request caches.

    pools (N,bs,K,D); block_tables (B,nb) int32, -1 = unused (clamped to
    block 0).  Returns (k, v, cache_pos) with caches (B, nb*bs, K, D) and
    cache_pos (B, nb*bs) holding each slot's implicit absolute position
    (logical block j covers [j*bs, (j+1)*bs)), -1 for pad slots."""
    N, bs, K, D = k_pool.shape
    B, nb = block_tables.shape
    bt = block_tables.clamp(min=0).long()
    k = k_pool[bt].reshape(B, nb * bs, K, D)
    v = v_pool[bt].reshape(B, nb * bs, K, D)
    flat = torch.arange(nb * bs, dtype=torch.int32,
                        device=block_tables.device)[None, :]
    valid = torch.repeat_interleave(block_tables >= 0, bs, dim=1)
    cache_pos = torch.where(valid, flat, torch.full_like(flat, -1))
    return k, v, cache_pos


def dequant_pool(k_pool, v_pool, k_scale, v_scale):
    """Dequantize quantized pool leaves back to f32 pools (one f32 scale
    per pool slot per kv-head)."""
    return dequantize_kv(k_pool, k_scale), dequantize_kv(v_pool, v_scale)


def _attend(q, k, v, q_pos, cache_pos, *, window, softcap, scale):
    """q (t,H,D) against one request's dense cache k/v (L,K,D) with slot
    positions cache_pos (L,); returns f32 (t,H,D)."""
    t, H, D = q.shape
    K = k.shape[1]
    qh = q.reshape(t, K, H // K, D).float()
    s = torch.einsum("tkgd,lkd->tkgl", qh, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = (cache_pos[None, :] >= 0) & (cache_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask &= (q_pos[:, None] - cache_pos[None, :]) < window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("tkgl,lkd->tkgd", p, v.float()).reshape(t, H, D)


def ragged_paged_attention_ref(q, k_pool, v_pool, block_tables, row_ids,
                               token_pos, *, window: int | None = None,
                               softcap: float | None = None,
                               scale: float | None = None):
    """Each packed token attends causally over its request row's blocks.

    q: (T,H,D) packed tokens; pools (N,bs,K,D); block_tables (R,nb) int32
    (-1 = unused); row_ids (T,) request row per token (-1 = pad); token_pos
    (T,) absolute positions (-1 = pad).  Pad lanes return exact zeros.

    Tables are dense prefixes, so the columns past the longest live count
    are -1 in every row; dropping them is exact, which makes the output
    bit-invariant to widening the tables with -1 columns."""
    T, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.zeros((T, H, D), dtype=torch.float32, device=q.device)
    n_live = int((block_tables >= 0).sum(dim=1).max()) if len(block_tables) else 0
    if n_live == 0:
        return out.to(q.dtype)
    bt = block_tables[:, :n_live]
    valid = (row_ids >= 0) & (token_pos >= 0)
    for r in torch.unique(row_ids[valid]).tolist():
        sel = valid & (row_ids == r)
        k, v, cpos = densify_pool(k_pool, v_pool, bt[r:r + 1])
        out[sel] = _attend(q[sel], k[0], v[0], token_pos[sel], cpos[0],
                           window=window, softcap=softcap, scale=scale)
    return out.to(q.dtype)


def ragged_paged_attention_quant_ref(q, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, row_ids, token_pos, *,
                                     window: int | None = None,
                                     softcap: float | None = None,
                                     scale: float | None = None):
    """Quantized-pool version: dequantize, then run the ragged version."""
    kd, vd = dequant_pool(k_pool, v_pool, k_scale, v_scale)
    return ragged_paged_attention_ref(q, kd, vd, block_tables, row_ids,
                                      token_pos, window=window,
                                      softcap=softcap, scale=scale)
