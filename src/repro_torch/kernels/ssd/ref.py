"""Plain PyTorch version of the SSD chunked-scan kernel (K3): the chunked
SSD of the JAX package's ``models/mamba2.py::ssd_chunked``, the function its
Mamba-2 block runs, with the TPU kernel's optional D-term added.

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel against it
on the card; the model on the card never calls it.  Per chunk of Q steps
it forms the intra-chunk quadratic term and the chunk's state, then scans
the chunk states in order; everything is f32.
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

    # intra-chunk: decay exp(cum_i - cum_j) selected on j <= i (above the
    # diagonal exp may overflow to inf, which the select drops)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)             # (B,NC,Q,Q)
    rel = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]  # (B,NC,Q,Q,H)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal[None, None, :, :, None], torch.exp(rel),
                        torch.zeros((), device=x.device))
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
