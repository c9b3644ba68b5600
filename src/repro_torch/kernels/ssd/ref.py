"""Plain PyTorch version of the SSD chunked-scan kernel (K3): the chunked
SSD of the JAX package's ``models/mamba2.py::ssd_chunked``, the function its
Mamba-2 block runs, with the TPU kernel's optional D-term added.

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel against it
on the card; the model on the card never calls it.  Per chunk of Q steps
it forms the intra-chunk quadratic term and the chunk's state, then scans
the chunk states in order; everything is f32.

Beside it, the kernel's three stages one by one (``ssd_stages_ref``
composes them): the chunk state (with the chunk's prefix sum of dt·A and
C·Bᵀ, shared by every head), the sequential pass over the chunk states,
and the chunk scan.  With ``split=True`` each f32 operand that the
kernel's tensor-core products take (B ⊙ w, the weighted scores, h_prev)
is rounded to the two bf16 terms hi + lo the kernel feeds them as
(``split_bf16``); with ``pad=True`` Q is padded to a multiple of 64 and P
and N to multiples of 16 with zeros, as the kernel pads its tiles in
shared memory.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked_ref(x, dt, A, B_, C_, D=None, *, chunk: int, h0=None):
    """x: (B,S,H,P); dt: (B,S,H) (already softplus'd); A: (H,) negative;
    B_, C_: (B,S,N) shared by every head; D: optional (H,) skip term, added
    as ``D·x``; h0: optional (B,H,P,N) f32 initial state.  Returns (f32 y
    (B,S,H,P), f32 h_final (B,H,P,N)).

    Q = min(chunk, S); a ragged tail is padded with dt = 0, which leaves
    the state unchanged, and its rows are dropped from y."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    NC = (S + pad) // Q
    xc = x.reshape(Bb, NC, Q, H, P).float()
    dtc = dt.reshape(Bb, NC, Q, H).float()
    Bc = B_.reshape(Bb, NC, Q, N).float()
    Cc = C_.reshape(Bb, NC, Q, N).float()

    cum_a = torch.cumsum(dtc * A.float(), dim=2)            # (B,NC,Q,H)
    dtx = dtc[..., None] * xc                                # (B,NC,Q,H,P)

    # intra-chunk: decay exp(cum_i - cum_j) on j <= i.  Above the diagonal
    # rel is a sum of -dt·A > 0 that may pass exp's range; it is zeroed
    # before the exp, not only selected away after it: an inf there would
    # make the gradient 0·inf = NaN (the JAX package's selects after the
    # exp and gets NaN gradients once a chunk's decay passes e^88: ROADMAP
    # F13).  The values are the same either way.
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)             # (B,NC,Q,Q)
    rel = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]  # (B,NC,Q,Q,H)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    keep = causal[None, None, :, :, None]
    zero = torch.zeros((), device=x.device)
    decay = torch.where(keep, torch.exp(torch.where(keep, rel, zero)), zero)
    y = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", CB, decay, dtx)

    # per-chunk states, then the sequential scan over chunks
    seg = torch.exp(cum_a[:, :, -1:, :] - cum_a)             # decay j → end
    s_chunk = torch.einsum("bckn,bckh,bckhp->bchpn", Bc, seg, dtx)
    chunk_decay = torch.exp(cum_a[:, :, -1, :])              # (B,NC,H)
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    prev = []
    for c in range(NC):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (B,NC,H,P,N)

    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, prev_states,
                         torch.exp(cum_a))
    y = y.reshape(Bb, NC * Q, H, P)[:, :S]
    if D is not None:
        y = y + D.float()[None, None, :, None] * x[:, :S].float()
    return y, h



# ------------------------------------------------------ the kernel's stages
TILE_Q, TILE_PN = 64, 16     # the kernel pads Q to TILE_Q, P and N to TILE_PN


def split_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` as the tensor-core products see it: hi = bf16(t) plus
    lo = bf16(t - hi), two bf16 operands whose f32-accumulated products add
    up to (hi + lo)·b (the sum is exact in f32; it keeps about 16 of t's 24
    significant bits)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def _chunked(x, dt, B_, C_, Q):
    """(B,NC,Q,H,P), (B,NC,Q,H), (B,NC,Q,N) twice, all f32; a ragged tail
    is padded with zeros (dt = 0 leaves the state unchanged)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    NC = (S + pad) // Q
    return (x.reshape(Bb, NC, Q, H, P).float(),
            dt.reshape(Bb, NC, Q, H).float(),
            B_.reshape(Bb, NC, Q, N).float(), C_.reshape(Bb, NC, Q, N).float())


def ssd_chunk_cb(Cc, Bc):
    """C·Bᵀ of every chunk, (B,NC,Q,Q): once per (batch row, chunk) for
    every head (n_groups = 1).  C and B are bf16 on the served path, so
    the kernel's single bf16 product with f32 accumulation is exact."""
    return torch.einsum("bcqn,bckn->bcqk", Cc, Bc)


def ssd_chunk_state(xc, dtc, A, Bc, *, split: bool = False):
    """Stage 1, per (batch row, chunk, head): cum (B,NC,Q,H), the prefix
    sum of dt·A over the chunk, and the chunk state s_c = xᵀ·(B ⊙ w)
    (B,NC,H,P,N) with w_j = exp(cum_end - cum_j)·dt_j.  Returns (cum,
    states)."""
    cum = torch.cumsum(dtc * A.float(), dim=2)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc             # (B,NC,Q,H)
    bw = Bc[:, :, :, None, :] * w[..., None]                 # (B,NC,Q,H,N)
    if split:
        bw = split_bf16(bw)
    return cum, torch.einsum("bcqhp,bcqhn->bchpn", xc, bw)


def ssd_state_pass(states, cum_end, h0=None):
    """Stage 2, the only sequential part: NC elementwise f32 steps
    h_prev[c] = h, h = exp(cum_end[c])·h + s_c from h0 (or zeros).
    states (B,NC,H,P,N), cum_end (B,NC,H).  Returns (h_prev (B,NC,H,P,N),
    h_final (B,H,P,N)); the kernel writes h_prev over the states."""
    Bb, NC, H, P, N = states.shape
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32,
                     device=states.device) if h0 is None else h0.float())
    prev = []
    for c in range(NC):
        prev.append(h)
        h = torch.exp(cum_end[:, c])[:, :, None, None] * h + states[:, c]
    return torch.stack(prev, dim=1), h


def ssd_chunk_scan(xc, dtc, cum, Cc, cb, h_prev, D=None, *,
                   split: bool = False):
    """Stage 3, per (batch row, chunk, head): y = (CB ⊙ exp(cum_i - cum_j)
    ⊙ dt_j ⊙ [j <= i])·x + exp(cum_i) ⊙ (C·h_prevᵀ) (+ D·x), f32
    (B,NC,Q,H,P).  The decay is formed only where j <= i: above the
    diagonal exp may overflow, and inf·0 is NaN."""
    Q = xc.shape[2]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=xc.device).tril()
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,NC,Q,Q,H)
    decay = torch.where(causal[None, None, :, :, None], torch.exp(rel),
                        torch.zeros((), device=xc.device))
    scores = cb[..., None] * (decay * dtc[:, :, None, :, :])
    if split:
        scores, h_prev = split_bf16(scores), split_bf16(h_prev)
    y = torch.exp(cum)[..., None] * torch.einsum("bcqn,bchpn->bcqhp", Cc,
                                                 h_prev)
    y = y + torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)
    if D is not None:
        y = y + D.float()[None, None, None, :, None] * xc
    return y


def ssd_stages_ref(x, dt, A, B_, C_, D=None, *, chunk: int, h0=None,
                   split: bool = False, pad: bool = False):
    """``ssd_chunked_ref`` composed of the kernel's stages, in its layout
    and with its options (see the module note for ``split`` and ``pad``).
    Returns (f32 y (B,S,H,P), f32 h_final (B,H,P,N))."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    xc, dtc, Bc, Cc = _chunked(x, dt, B_, C_, Q)
    if pad:
        qp = (-Q) % TILE_Q
        pp, np_ = (-P) % TILE_PN, (-N) % TILE_PN
        xc = F.pad(xc, (0, pp, 0, 0, 0, qp))
        dtc = F.pad(dtc, (0, 0, 0, qp))
        Bc, Cc = (F.pad(t, (0, np_, 0, qp)) for t in (Bc, Cc))
        if h0 is not None:
            h0 = F.pad(h0, (0, np_, 0, pp))
    cum, states = ssd_chunk_state(xc, dtc, A, Bc, split=split)
    h_prev, h_final = ssd_state_pass(states, cum[:, :, -1], h0)
    y = ssd_chunk_scan(xc, dtc, cum, Cc, ssd_chunk_cb(Cc, Bc), h_prev, D,
                       split=split)
    y = y[:, :, :Q, :, :P].reshape(Bb, -1, H, P)[:, :S]
    return y, h_final[:, :, :P, :N]
