"""Mamba-2 block: SSD (state-space duality) with a chunked scan [arXiv:2405.21060].

Port of the JAX package's ``models/mamba2.py``.  Layout:
  d_inner = expand · d_model;  heads H = d_inner / head_dim P;  state N;
  in_proj emits [z (d_inner) | x (d_inner) | B (N) | C (N) | dt (H)];
  (x|B|C) pass through a causal depthwise conv (width W) + SiLU;
  h_t = exp(dt·A)·h_{t-1} + dt·B_t ⊗ x_t,   y_t = C_t·h_t + D·x_t;
  output: rmsnorm(y · silu(z)) → out_proj.  (n_groups = 1: B/C shared by heads.)

The full-sequence and prefill branch runs the scan through the K3 wrapper
(``kernels/ssd/ops.py``: the CUDA kernel for CUDA tensors, the plain chunked
SSD for CPU tensors) and adds the D-term itself, in f32, after it.  The
one-token decode branch stays plain PyTorch, as in the JAX package: no TPU
kernel covers it.

Decode carries {"conv": (B, W-1, conv_dim), "ssm": (B, H, P, N) f32}: O(1)
state whatever the context length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops

from .config import ModelConfig
from .layers import dense_init, dtype_of, rmsnorm, rmsnorm_init


# ------------------------------------------------------------------ params
def mamba_init(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N
    dt = dtype_of(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, (d, 2 * di + 2 * N + H), dt, device),
        "conv_w": dense_init(generator, (cfg.conv_width, conv_dim), dt, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.zeros((H,), **f32),          # A = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "out_norm": rmsnorm_init(di, device),
        "out_proj": dense_init(generator, (di, d), dt, device),
    }


def mamba_cache_init(cfg: ModelConfig, batch: int, *, device) -> dict:
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * N),
                            dtype=dtype_of(cfg), device=device),
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
    }


# ------------------------------------------------------------------- split
def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * N],
            proj[..., 2 * di + 2 * N:])


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """(B,S,C) depthwise causal conv, width W, then SiLU."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu(out + b)


# --------------------------------------------------------------- SSD scan
def ssd_decode_step(h, x, dt, A, B_, C_):
    """One token.  h: (B,H,P,N) f32; x: (B,H,P); dt: (B,H); B_, C_: (B,N).
    Returns (y (B,H,P) f32, new h)."""
    dec = torch.exp(dt * A)                                   # (B,H)
    dtx = (dt[..., None] * x).float()                         # (B,H,P)
    h = h * dec[:, :, None, None] + dtx[..., None] * B_[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, C_.float())
    return y, h


# ------------------------------------------------------------------- block
def mamba_block(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
                cache: dict | None = None
                ) -> tuple[torch.Tensor, dict | None]:
    """x: (B,S,d).  cache=None → full sequence; with a cache, S = 1 decodes
    one step and S > 1 prefills from the cache's state.  Returns (out, the
    new cache or None); the given cache is not modified."""
    Bb, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    A = -torch.exp(params["A_log"])
    proj = x @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(cfg, proj)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])

    if cache is not None and S == 1:
        win = torch.cat([cache["conv"], xBC], dim=1)           # (B,W,conv)
        conv_out = F.silu(torch.einsum("bwc,wc->bc", win, params["conv_w"])
                          + params["conv_b"])[:, None, :]
        xs = conv_out[..., :di].reshape(Bb, H, P)
        B_ = conv_out[:, 0, di:di + N]
        C_ = conv_out[:, 0, di + N:]
        y, h = ssd_decode_step(cache["ssm"], xs, dt[:, 0], A, B_, C_)
        y = y + params["D"][None, :, None] * xs
        y = y.reshape(Bb, 1, di).to(x.dtype)
        new_cache = {"conv": win[:, 1:, :], "ssm": h}
    else:
        conv_out = _causal_conv(xBC, params["conv_w"], params["conv_b"])
        xs = conv_out[..., :di].reshape(Bb, S, H, P)
        h0 = cache["ssm"] if cache is not None else None
        y, h_final = ssd_ops.ssd(
            xs.contiguous(), dt.contiguous(), A,
            conv_out[..., di:di + N].contiguous(),
            conv_out[..., di + N:].contiguous(), chunk=cfg.ssm_chunk, h0=h0)
        y = y + params["D"][None, None, :, None] * xs.float()
        y = y.reshape(Bb, S, di).to(x.dtype)
        new_cache = None
        if cache is not None:
            new_cache = {"conv": xBC[:, -(cfg.conv_width - 1):, :],
                         "ssm": h_final}

    y = y * F.silu(z)
    y = rmsnorm(params["out_norm"], y)
    return y @ params["out_proj"], new_cache
