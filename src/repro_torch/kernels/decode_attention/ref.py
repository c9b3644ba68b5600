"""Plain PyTorch versions of the decode-attention kernels (port of the JAX
package's ``kernels/decode_attention/ref.py`` oracles): the ragged paged
attention of K1 and the dense one-token decode attention of K4.

The CPU tests run them, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card; the served paths on the card never call them.  The ragged
version gathers one request row at a time (not one densified cache per
token), so it also runs at the serving shapes: the largest buffers are one
row's (L, K, D) cache and its (tokens, K, G, L) scores.

The split-KV helpers at the end mirror ``kernels/csrc/split_kv.cuh`` step
for step: the span plan (which spans a query has and which keys each holds),
the partial (m, l, acc) of one span, and the ordered combine; and, built on
them, plain emulations of the two split kernels
(``decode_attention_split``, ``ragged_paged_attention_split``) that the
tests hold against the plain versions above and the JAX package's refs.
"""
from __future__ import annotations

import torch

from .quant import dequantize_kv

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, q_pos, cache_pos, *,
                         window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None, lse: bool = False):
    """One new token per row against its dense cache.  q: (B,H,D);
    k_cache/v_cache: (B,S,K,D); cache_pos: (B,S) absolute position of each
    slot (-1 empty); q_pos: (B,) the new token's position.  Slot s is
    visible iff 0 <= cache_pos <= q_pos (and q_pos - cache_pos < window), so
    ring buffers and partly filled rows need nothing else.  Scores in f32,
    tanh softcap after the scale, f32 softmax (a row with nothing visible
    averages its S values uniformly).  Returns (B,H,D) in q's dtype;
    ``lse``: also each (row, head)'s f32 log-sum-exp of its visible scores
    (-inf with none), (B,H)."""
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
    out = out.reshape(B, H, D).to(q.dtype)
    if not lse:
        return out
    seen = mask.any(dim=-1)[:, None, None]
    total = torch.where(seen, torch.logsumexp(s, dim=-1), float("-inf"))
    return out, total.reshape(B, H)


def decode_attention_quant_ref(q, k_cache, v_cache, k_scale, v_scale, q_pos,
                               cache_pos, *, window: int | None = None,
                               softcap: float | None = None,
                               scale: float | None = None,
                               lse: bool = False):
    """Quantized-cache version: int8 / fp8 caches with (B,S,K) f32 scales
    are dequantized, then the dense version runs."""
    return decode_attention_ref(
        q, dequantize_kv(k_cache, k_scale), dequantize_kv(v_cache, v_scale),
        q_pos, cache_pos, window=window, softcap=softcap, scale=scale,
        lse=lse)


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
    # lint: allow-sync(the plain version: the CPU route and card checks)
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


# ============================================================ split KV
K4_SPAN_SLOTS = 256       # C4: K4 cuts a row's S slots into spans of these
K1_SPAN_BLOCKS = 32       # C1: K1 cuts a row's table blocks into spans


def n_spans(n_keys: int, span: int) -> int:
    """The grid's span axis: ceil(n_keys / span), from the shapes alone."""
    return -(-n_keys // span)


def workspace_elems(units: int, K: int, n_span: int, G: int, D: int) -> int:
    """f32 elements of the partials' workspace: acc (units, K, n_span, G, D)
    then m and l (units, K, n_span, G) each."""
    return units * K * n_span * G * (D + 2)


def paged_span_plan(qp: int, live: int, nb: int, bs: int,
                    window: int | None, span: int) -> list:
    """K1's spans of one token: for each of the n_spans(nb, span) spans,
    the table blocks [j_lo, j_hi) it walks, or None when it writes an empty
    partial.  The ranges depend only on the position, the window and the
    row's live-block count, so -1 columns added to a table add only None
    entries."""
    plan = []
    for s in range(n_spans(nb, span)):
        j_lo, j_hi = s * span, min((s + 1) * span, nb)
        if qp >= 0:
            j_hi = min(j_hi, qp // bs + 1, live)
            if window is not None and qp - window + 1 > 0:
                j_lo = max(j_lo, (qp - window + 1) // bs)
        plan.append((j_lo, j_hi) if qp >= 0 and j_lo < j_hi else None)
    return plan


def span_partial(q, k, v, visible, *, scale, softcap):
    """The partial of one span: q (..., G, D), k/v (..., n, D) f32 rows of
    the span's keys, visible (..., n) bool.  Returns m, l (..., G) and acc
    (..., G, D) in f32: the scores' max over the visible keys, the sum of
    exp(s - m) over them and the exp-weighted sum of their V rows; an empty
    partial (m = NEG_INF, l = 0, acc = 0) where no key is visible."""
    s = torch.einsum("...gd,...nd->...gn", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    vis = visible[..., None, :]
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    # explicit re-mask: a wholly masked span would otherwise emit exp(0) = 1
    p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("...gn,...nd->...gd", p, v.float())
    m = torch.where(l > 0, m, torch.full_like(m, NEG_INF))
    return m, l, acc


def combine_spans(m, l, acc):
    """The ordered combine over the leading span axis: m, l (n_span, ...),
    acc (n_span, ..., D).  Spans with l == 0 are skipped, so they cannot
    change a bit; mm = max m_s, c_s = exp(m_s - mm), l = sum c_s l_s,
    acc = sum c_s acc_s, summed in span order.  Returns (acc, l); l == 0
    where no span holds a visible key."""
    full = l > 0
    mm = torch.where(full, m, torch.full_like(m, NEG_INF)).amax(dim=0)
    l_out = torch.zeros_like(mm)
    acc_out = torch.zeros_like(acc[0])
    for s in range(m.shape[0]):
        c = torch.where(full[s], torch.exp(m[s] - mm), torch.zeros_like(mm))
        l_out = l_out + c * l[s]
        acc_out = acc_out + c[..., None] * acc[s]
    return acc_out, l_out


def decode_attention_split(q, k_cache, v_cache, q_pos, cache_pos, *,
                           k_scale=None, v_scale=None,
                           window: int | None = None,
                           softcap: float | None = None,
                           scale: float | None = None,
                           span: int = K4_SPAN_SLOTS):
    """K4 as the split kernel computes it: spans of ``span`` slots cut by
    slot index, one partial per (row, kv-head, span), the ordered combine;
    a row with nothing visible averages its S values uniformly.  Returns
    (B,H,D) in q's dtype."""
    B, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = D ** -0.5 if scale is None else scale
    k = k_cache.float() if k_scale is None else dequantize_kv(k_cache, k_scale)
    v = v_cache.float() if v_scale is None else dequantize_kv(v_cache, v_scale)
    vis = (cache_pos >= 0) & (cache_pos <= q_pos[:, None])
    if window is not None:
        vis &= (q_pos[:, None] - cache_pos) < window
    n = n_spans(S, span)
    pad = n * span - S
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    visp = torch.nn.functional.pad(vis, (0, pad))
    # (n, B, K, span, D) rows and (n, B, K, span) visibility per span
    kp = kp.reshape(B, n, span, K, D).permute(1, 0, 3, 2, 4)
    vp = vp.reshape(B, n, span, K, D).permute(1, 0, 3, 2, 4)
    visp = visp.reshape(B, n, 1, span).permute(1, 0, 2, 3).expand(
        n, B, K, span)
    qh = q.reshape(1, B, K, G, D).float()
    m, l, acc = span_partial(qh, kp, vp, visp, scale=scale, softcap=softcap)
    acc, l = combine_spans(m, l, acc)
    empty = l == 0
    uniform = v.mean(dim=1)[:, :, None, :].expand(B, K, G, D)
    out = torch.where(empty[..., None], uniform,
                      acc / torch.where(empty, torch.ones_like(l), l)[..., None])
    return out.reshape(B, H, D).to(q.dtype)


def ragged_paged_attention_split(q, k_pool, v_pool, block_tables, row_ids,
                                 token_pos, *, k_scale=None, v_scale=None,
                                 window: int | None = None,
                                 softcap: float | None = None,
                                 scale: float | None = None,
                                 span: int = K1_SPAN_BLOCKS):
    """K1 as the split kernel computes it: each token's span plan
    (``paged_span_plan``), one partial per (token, kv-head, span), the
    ordered combine; pad lanes (row_ids or token_pos < 0) and tokens with
    nothing visible are exact zeros.  Returns (T,H,D) in q's dtype."""
    T, H, D = q.shape
    N, bs, K, _ = k_pool.shape
    G = H // K
    R, nb = block_tables.shape
    scale = D ** -0.5 if scale is None else scale
    k = k_pool.float() if k_scale is None else dequantize_kv(k_pool, k_scale)
    v = v_pool.float() if v_scale is None else dequantize_kv(v_pool, v_scale)
    n = n_spans(nb, span)
    out = torch.zeros((T, H, D), dtype=torch.float32, device=q.device)
    for t in range(T):
        rid, qp = int(row_ids[t]), int(token_pos[t])
        if rid < 0 or qp < 0:
            continue
        bt = block_tables[min(rid, R - 1)]
        live = int((bt >= 0).sum())
        m = torch.full((n, K, G), NEG_INF)
        l = torch.zeros((n, K, G))
        acc = torch.zeros((n, K, G, D))
        qh = q[t].reshape(K, G, D).float()
        for s, blocks in enumerate(paged_span_plan(qp, live, nb, bs, window,
                                                   span)):
            if blocks is None:
                continue
            pos = torch.arange(blocks[0] * bs, blocks[1] * bs)
            slot = bt[pos // bs].clamp(min=0).long() * bs + pos % bs
            rows_k = k.reshape(N * bs, K, D)[slot].permute(1, 0, 2)
            rows_v = v.reshape(N * bs, K, D)[slot].permute(1, 0, 2)
            vis = pos <= qp
            if window is not None:
                vis &= (qp - pos) < window
            m[s], l[s], acc[s] = span_partial(
                qh, rows_k, rows_v, vis.expand(K, -1), scale=scale,
                softcap=softcap)
        a, ll = combine_spans(m, l, acc)
        out[t] = (a / torch.where(ll == 0, torch.ones_like(ll),
                                  ll)[..., None]).reshape(H, D)
    return out.to(q.dtype)


# ============================================= K1's tensor-core path (bf16 q)
K1_TC_ROWS = 64          # query rows (lane x head) of a segment: tc::ROWS


def k1_segment_lanes(G: int) -> int:
    """BL: the most lanes a segment holds, ``K1_TC_ROWS // G``."""
    return K1_TC_ROWS // G


def k1_key_tile(D: int) -> int:
    """KT: keys a tile, tiles starting at multiples of it
    (``tc::key_tile``)."""
    return 64 if D <= 128 else 32


def _follows(row_ids, token_pos, t: int, bl: int) -> bool:
    p = int(token_pos[t])
    return (t > 0 and p % bl != 0 and int(row_ids[t - 1]) == int(row_ids[t])
            and int(token_pos[t - 1]) == p - 1)


def ragged_segment_plan(block_tables, row_ids, token_pos, *, G: int,
                        bs: int, window: int | None = None,
                        span: int = K1_SPAN_BLOCKS) -> list[dict]:
    """K1's segments as ``ragged_tc_plan_kernel`` finds them, in lane order
    (the kernel claims them in any order).  A valid lane leads a segment
    unless lane t - 1 has the same row and the previous position and its
    own position is not a multiple of BL (``k1_segment_lanes(G)``); the
    leader takes the lanes that follow it, so a segment is one row's run of
    consecutive positions within one BL-aligned block.  Pad lanes (row or
    position < 0) are in none.

    Each segment: ``first`` lane, ``n`` lanes, ``row``, ``pos0`` (its first
    position), the row's ``live`` block count and, per span, the union
    ``(lo, hi)`` of its lanes' visible positions there or None (an empty
    partial), as ``ragged_tc_kernel`` computes it.  The ranges depend only
    on the positions, the window and ``live``, so -1 columns added to a
    table add only None entries."""
    T = len(row_ids)
    R, nb = block_tables.shape
    bl = k1_segment_lanes(G)
    segs = []
    for t in range(T):
        r, p = int(row_ids[t]), int(token_pos[t])
        if r < 0 or p < 0 or _follows(row_ids, token_pos, t, bl):
            continue
        n = 1
        while t + n < T and _follows(row_ids, token_pos, t + n, bl):
            n += 1
        live = int((block_tables[min(r, R - 1)] >= 0).sum())
        ranges = []
        for s in range(n_spans(nb, span)):
            j0, j1 = s * span, min((s + 1) * span, nb)
            lo, hi = j0 * bs, min(j1 * bs, p + n)
            if window is not None:
                lo = max(lo, p - window + 1)
            if lo < hi:
                hi = min(hi, j1 * bs, live * bs)
            ranges.append((lo, hi) if lo < hi else None)
        segs.append(dict(first=t, n=n, row=r, pos0=p, live=live,
                         ranges=ranges))
    return segs


def _ordered_dot(a, b):
    """a (..., M, Dp) . b (..., KT, Dp) -> (..., M, KT), summed over the
    last axis one element at a time in order, so trailing zero columns add
    exact zeros."""
    s = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32)
    for d in range(a.shape[-1]):
        s = s + a[..., :, d, None] * b[..., None, :, d]
    return s


def _ordered_pv(acc, p, v):
    """acc + p (..., M, KT) @ v (..., KT, D), key by key in order."""
    for k in range(p.shape[-1]):
        acc = acc + p[..., :, k, None] * v[..., None, k, :]
    return acc


def tile_update(m, l, acc, s, visible, v, v_scale=None):
    """One key tile's online-softmax step of ``ragged_tc_kernel`` for rows
    (..., M): running max m and sum l (..., M), acc (..., M, D); the tile's
    scores s (..., M, KT) (scaled, capped; K's scale already applied),
    ``visible`` (..., M, KT) each row's own mask, v (..., KT, D) the stored
    values (int8 / fp8 codes as they are) and ``v_scale`` (..., KT) or
    None.  V's scale is folded into p, and p times it is split into bf16
    hi + lo for P·V, as the kernel does.  A row that sees no key of the
    tile keeps (m, l, acc) bit for bit: its max stays m, so alpha is
    exactly 1 (never exp(NEG_INF - NEG_INF)), and its p is exactly 0."""
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    mn = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.where(mn == m, torch.ones_like(m), torch.exp(m - mn))
    p = torch.where(visible, torch.exp(s - mn[..., None]),
                    torch.zeros_like(s))
    l = l * alpha + p.sum(dim=-1)
    pv = p if v_scale is None else p * v_scale[..., None, :]
    hi = pv.to(torch.bfloat16).float()
    lo = (pv - hi).to(torch.bfloat16).float()
    acc = acc * alpha[..., None]
    for k0 in range(0, s.shape[-1], 16):       # the kernel's k16 steps
        ks = slice(k0, k0 + 16)
        acc = _ordered_pv(acc, hi[..., ks], v[..., ks, :])
        acc = _ordered_pv(acc, lo[..., ks], v[..., ks, :])
    return mn, l, acc


def ragged_paged_attention_tiled(q, k_pool, v_pool, block_tables, row_ids,
                                 token_pos, *, k_scale=None, v_scale=None,
                                 window: int | None = None,
                                 softcap: float | None = None,
                                 scale: float | None = None,
                                 span: int = K1_SPAN_BLOCKS,
                                 key_tile: int | None = None,
                                 pad_d: bool = True):
    """K1 as ``ragged_tc_kernel`` computes it: the segments of
    ``ragged_segment_plan``; per (segment, kv-head, span) the segment's
    n x G query rows (lane-major, then head) walk the span's key tiles of
    ``key_tile`` positions (``k1_key_tile(D)``), which start at multiples
    of it, over the union of the lanes' ranges; each row keeps its own mask
    and online softmax (``tile_update``); K's scale multiplies the score
    after the dot, V's is folded into p; then the ordered combine of the
    spans (``combine_spans``).  q and K are zero-padded along D to a
    multiple of 16 as the kernel pads them (``pad_d``).  Pad lanes and
    lanes with nothing visible are exact zeros.  Returns (T,H,D) in q's
    dtype."""
    T, H, D = q.shape
    N, bs, K, _ = k_pool.shape
    G = H // K
    R, nb = block_tables.shape
    scale = D ** -0.5 if scale is None else scale
    kt = k1_key_tile(D) if key_tile is None else key_tile
    dp = -(-D // 16) * 16 if pad_d else D
    n = n_spans(nb, span)
    kf = k_pool.float().reshape(N * bs, K, D)
    vf = v_pool.float().reshape(N * bs, K, D)
    quant = k_scale is not None
    m_ws = torch.full((n, T, K, G), NEG_INF)
    l_ws = torch.zeros((n, T, K, G))
    a_ws = torch.zeros((n, T, K, G, D))
    for seg in ragged_segment_plan(block_tables, row_ids, token_pos, G=G,
                                   bs=bs, window=window, span=span):
        t0, cnt, p0 = seg["first"], seg["n"], seg["pos0"]
        bt = block_tables[min(seg["row"], R - 1)]
        M = cnt * G
        qs = q[t0:t0 + cnt].float().reshape(cnt, K, G, D).permute(
            1, 0, 2, 3).reshape(K, M, D)
        qs = torch.nn.functional.pad(qs, (0, dp - D))
        qp = p0 + torch.arange(M) // G
        for s, rng in enumerate(seg["ranges"]):
            if rng is None:
                continue
            lo, hi = rng
            span_lo = s * span * bs
            kend = min(min((s + 1) * span, nb) * bs, seg["live"] * bs)
            m = torch.full((K, M), NEG_INF)
            l = torch.zeros((K, M))
            acc = torch.zeros((K, M, D))
            for tile in range(lo // kt, (hi - 1) // kt + 1):
                pos = torch.arange(tile * kt, (tile + 1) * kt)
                loaded = (pos >= lo) & (pos < hi)
                pc = pos.clamp(lo, hi - 1)
                slot = bt[pc // bs].clamp(min=0).long() * bs + pc % bs
                keep = loaded[:, None, None]
                kr = torch.where(keep, kf[slot], 0.0).permute(1, 0, 2)
                vr = torch.where(keep, vf[slot], 0.0).permute(1, 0, 2)
                dot = _ordered_dot(qs, torch.nn.functional.pad(
                    kr, (0, dp - D)))
                vs = None
                if quant:
                    ks = torch.where(loaded[:, None], k_scale.reshape(
                        N * bs, K)[slot], 0.0).T
                    vs = torch.where(loaded[:, None], v_scale.reshape(
                        N * bs, K)[slot], 0.0).T
                    dot = dot * ks[:, None, :]
                sc = dot * scale
                if softcap is not None:
                    sc = softcap * torch.tanh(sc / softcap)
                vis = ((pos >= span_lo) & (pos < kend))[None, :] & (
                    pos[None, :] <= qp[:, None])
                if window is not None:
                    vis &= (qp[:, None] - pos[None, :]) < window
                m, l, acc = tile_update(m, l, acc, sc, vis.expand(K, -1, -1),
                                        vr, vs)
            m_ws[s, t0:t0 + cnt] = m.reshape(K, cnt, G).permute(1, 0, 2)
            l_ws[s, t0:t0 + cnt] = l.reshape(K, cnt, G).permute(1, 0, 2)
            a_ws[s, t0:t0 + cnt] = acc.reshape(K, cnt, G, D).permute(
                1, 0, 2, 3)
    a, ll = combine_spans(m_ws, l_ws, a_ws)
    out = a / torch.where(ll == 0, torch.ones_like(ll), ll)[..., None]
    return out.reshape(T, H, D).to(q.dtype)
