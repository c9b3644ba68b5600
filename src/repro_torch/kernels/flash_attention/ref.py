"""Plain PyTorch version of the flash-attention kernel (port of the JAX
package's ``kernels/flash_attention/ref.py`` oracle).

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel against it
on the card; the forward on the card never calls it.  It loops over query
chunks and gives each chunk only the keys its causal band and window can
reach (a dropped key would get probability exactly 0), so it also runs at
full-width shapes: the largest buffer is one chunk's (B, K, G, chunk, keys)
f32 scores, never the (S, S) matrix of every head pair at once.

Under autograd each chunk runs inside ``torch.utils.checkpoint``
(non-reentrant), as the JAX package wraps its query-chunk body in
``jax.checkpoint`` (``models/attention.py``): the backward recomputes one
chunk's scores and softmax at a time instead of keeping every chunk's.
K2's backward (``ops._FlashAttention``) differentiates this function, so
its peak is one chunk's too.  The forward's bits are the same either way.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def attention_ref(q, k, v, *, window: int | None = None,
                  softcap: float | None = None, scale: float | None = None,
                  q_chunk: int = 512):
    """q: (B,S,H,D); k,v: (B,S,K,D) with H % K == 0; query head h reads kv
    head h // (H/K).  Scores in f32, tanh softcap after the scale, key j
    visible to query i if j <= i and i - j < window; f32 softmax.  Returns
    (B,S,H,D) in q's dtype."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = D ** -0.5 if scale is None else scale
    qh = q.reshape(B, S, K, G, D).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, K, G, D), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    def chunk(qc, kc, vc, c0, lo):
        c1 = c0 + qc.shape[1]
        s = torch.einsum("btkgd,bskd->bkgts", qc, kc) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        i = torch.arange(c0, c1, device=q.device)[:, None]
        j = torch.arange(lo, c1, device=q.device)[None, :]
        mask = j <= i
        if window is not None:
            mask &= (i - j) < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgts,bskd->btkgd", p, vc)

    for c0 in range(0, S, q_chunk):
        c1 = min(S, c0 + q_chunk)
        lo = max(0, c0 - window + 1) if window is not None else 0
        args = (qh[:, c0:c1], kf[:, lo:c1], vf[:, lo:c1], c0, lo)
        out[:, c0:c1] = (checkpoint(chunk, *args, use_reentrant=False)
                         if remat else chunk(*args))
    return out.reshape(B, S, H, D).to(q.dtype)
