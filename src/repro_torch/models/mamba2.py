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

Split over m shards by SSM heads (``mamba_slice``, of which the one-device
``mamba_block`` is the one-shard case), each shard holds
its heads' z, x and dt columns of ``in_proj`` and 1/m of its B|C columns,
as ``shard_columns`` lays them out (so the rules' even split of the
``ffn`` dim is a split by heads), its heads' conv channels and 1/m of the
B|C ones, and its rows of ``out_proj``.  The conv'ed B|C pieces are
gathered, K3 runs on the shard's heads, and ``out_norm``'s sum of squares
and ``out_proj``'s partials are summed over the shards in shard order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops

from . import slices
from .config import ModelConfig
from .layers import (dense_init, dtype_of, matmul_f32, rmsnorm,
                     rmsnorm_axes, rmsnorm_init)
from .slices import TensorParallel


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


def mamba_axes(cfg: ModelConfig) -> dict:
    return {
        "in_proj": ("embed", "ffn"),
        "conv_w": (None, "ffn"),
        "conv_b": ("ffn",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "out_norm": rmsnorm_axes(),
        "out_proj": ("ffn", "embed"),
    }


def mamba_cache_axes() -> dict:
    return {"conv": ("cache_batch", None, "ffn"),
            "ssm": ("cache_batch", "heads", None, None)}


def mamba_cache_init(cfg: ModelConfig, batch: int, *, device, tp=None,
                     shard: int = 0) -> dict:
    """A zero decode state; a split slice's shard (``tp.ssm``) holds its
    conv channels and, when ``tp.ssm_state``, its SSM heads."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    m = tp.size if tp is not None and tp.ssm else 1
    conv = (di + 2 * N) // m
    heads = H // m if tp is not None and tp.ssm_state else H
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv),
                            dtype=dtype_of(cfg), device=device),
        "ssm": torch.zeros((batch, heads, P, N), dtype=torch.float32,
                           device=device),
    }


def shard_columns(cfg: ModelConfig, m: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(in_proj column order, conv channel order) of the shard-major layout
    over m shards: shard s's contiguous 1/m holds [z_s | x_s | BC_s | dt_s]
    of ``in_proj`` and [x_s | BC_s] of the conv, where z_s, x_s, dt_s are
    its H/m heads' columns and BC_s the s-th 1/m of the B|C columns.  The
    identity for m = 1."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    if H % m or (2 * N) % m:
        raise NotImplementedError(
            f"Stage 3 (Mamba-2 split by SSM heads) needs model={m} to "
            f"divide the {H} SSM heads and the {2 * N} B|C columns of "
            f"config {cfg.name}")
    hp, bc = H // m * P, 2 * N // m
    ar = lambda lo, n: torch.arange(lo, lo + n)
    proj, conv = [], []
    for s in range(m):
        proj += [ar(s * hp, hp), ar(di + s * hp, hp),
                 ar(2 * di + s * bc, bc), ar(2 * di + 2 * N + s * (H // m),
                                             H // m)]
        conv += [ar(s * hp, hp), ar(di + s * bc, bc)]
    return torch.cat(proj), torch.cat(conv)


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
    """x: (B,S,d) on one device, the one-shard case of ``mamba_slice``.
    cache=None → full sequence; with a cache, S = 1 decodes one step and
    S > 1 prefills from the cache's state.  Returns (out, the new cache or
    None); the given cache is not modified."""
    d = x.device
    out, new = mamba_slice([params], {d: x}, cfg=cfg,
                           tp=TensorParallel(devices=(d,)),
                           caches=None if cache is None else [cache])
    return out[d], new[0]


def mamba_slice(ps: list, hs: dict, *, cfg: ModelConfig, tp: TensorParallel,
                caches: list | None = None) -> tuple[dict, list]:
    """The block over a slice.  ``ps``: each shard's local params; ``hs``:
    the normed input (B, S, d) on every device; ``caches``: each shard's
    local cache (None: the full sequence; S = 1: one decode step; S > 1: a
    prefill from the caches' state).  Returns (out on every device, each
    shard's new cache, or Nones without caches).

    Split by SSM heads (``tp.ssm``, the ``shard_columns`` layout;
    ``A_log``, ``D``, ``dt_bias`` and ``out_norm`` whole on every shard):
    the conv'ed B|C pieces are gathered, K3 runs on the shard's heads, and
    ``out_norm``'s sum of squares and ``out_proj``'s f32 partials are
    summed in shard order (all-reduces); a replicated SSM state's heads
    are gathered.  Not split: every shard runs the whole block on its own
    copy, and each device reads its first shard's output."""
    split = tp.ssm
    m = tp.size if split else 1
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    hl, hp = H // m, H // m * P
    x0 = next(iter(hs.values()))
    Bb, S, _ = x0.shape
    decode = caches is not None and S == 1

    def stage_in(s, d):
        p = ps[s]
        proj = hs[d] @ p["in_proj"]
        z, xBC, dt_raw = proj[..., :hp], proj[..., hp:-hl], proj[..., -hl:]
        bias = p["dt_bias"][s * hl:(s + 1) * hl] if split else p["dt_bias"]
        dt = F.softplus(dt_raw.float() + bias)
        new_conv = None
        if decode:
            win = torch.cat([caches[s]["conv"], xBC], dim=1)  # (B,W,conv)
            conv = F.silu(torch.einsum("bwc,wc->bc", win, p["conv_w"])
                          + p["conv_b"])[:, None, :]
            new_conv = win[:, 1:, :]
        else:
            conv = _causal_conv(xBC, p["conv_w"], p["conv_b"])
            if caches is not None:
                # a copy: a view would keep the whole projection alive
                new_conv = xBC[:, -(cfg.conv_width - 1):, :].clone()
        return z, dt, conv, new_conv

    ins = slices.per_shard(tp, stage_in)
    # B|C: the gathered pieces (split), else each shard's own columns
    bc = slices.gather([i[2][..., hp:] for i in ins], tp, dim=-1) \
        if split else None
    at = 0 if split else hp

    def stage_scan(s, d):
        p = ps[s]
        z, dt, conv, _ = ins[s]
        src = bc[d] if split else conv
        # a split shard's heads of the per-head leaves
        heads = slice(s * hl, (s + 1) * hl)
        A_log, D = ((p["A_log"][heads], p["D"][heads]) if split
                    else (p["A_log"], p["D"]))
        A = -torch.exp(A_log)
        h0 = None
        if caches is not None:
            h0 = caches[s]["ssm"]
            if split and not tp.ssm_state:
                h0 = h0[:, heads].contiguous()
        if decode:
            xs = conv[..., :hp].reshape(Bb, hl, P)
            y, h = ssd_decode_step(h0, xs, dt[:, 0], A,
                                   src[:, 0, at:at + N], src[:, 0, at + N:])
            y = y + D[None, :, None] * xs
        else:
            xs = conv[..., :hp].reshape(Bb, S, hl, P)
            y, h = ssd_ops.ssd(xs.contiguous(), dt.contiguous(), A,
                               src[..., at:at + N].contiguous(),
                               src[..., at + N:].contiguous(),
                               chunk=cfg.ssm_chunk, h0=h0)
            y = y + D[None, None, :, None] * xs.float()
        y = y.reshape(Bb, -1, hp).to(x0.dtype) * F.silu(z)
        if not split:
            return y, h, None
        yf = y.float()
        return y, h, torch.sum(yf * yf, dim=-1, keepdim=True)

    scans = slices.per_shard(tp, stage_scan)
    if split:
        sq = slices.combine([sc[2] for sc in scans], tp, True, torch.float32)

    def stage_out(s, d):
        p, y = ps[s], scans[s][0]
        if not split:
            return rmsnorm(p["out_norm"], y) @ p["out_proj"]
        # the RMSNorm over the whole d_inner, from the summed squares
        rs = torch.rsqrt(sq[d] / di + 1e-6)
        scale = p["out_norm"]["scale"][s * hp:(s + 1) * hp]
        yn = (y.float() * rs * (1.0 + scale)).to(y.dtype)
        return matmul_f32(yn, p["out_proj"])

    out = slices.combine(slices.per_shard(tp, stage_out), tp, split,
                         x0.dtype)
    if caches is None:
        return out, [None] * len(tp.devices)
    states = [sc[1] for sc in scans]
    if split and not tp.ssm_state:
        # every shard keeps its own copy of the replicated state
        full = slices.gather(states, tp, dim=1)
        states = [full[d] if tp.first[d] == s else full[d].clone()
                  for s, d in enumerate(tp.devices)]
    return out, [{"conv": ins[s][3], "ssm": states[s]}
                 for s in range(len(tp.devices))]
