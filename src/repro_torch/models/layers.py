"""Shared layer primitives: norms, RoPE, embeddings, initializers.

Parameters are nested dicts of tensors with the JAX package's leaf names and
layouts, so a JAX params tree carries over leaf for leaf
(``lm.params_from_numpy``).  Numerics follow the reference:

- ``rmsnorm`` computes in f32 with a zero-centred ``(1 + scale)`` and casts
  back to the input dtype;
- ``rope`` is half-split (not interleaved), computed in f32, cast back;
- ``embed_lookup`` multiplies by ``sqrt(d)`` ROUNDED to the table dtype
  (59.75 in bf16 for d = 3584, not 59.87);
- ``unembed`` returns f32 logits from model-dtype operands;
- ``softcap`` casts back to the logits dtype.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ----------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm_axes() -> dict:
    return {"scale": (None,)}


def rmsnorm(params: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"])).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # the base is a CPU scalar: a device tensor built from a Python number
    # is a blocking upload, which a CUDA graph capture cannot hold
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    angles = positions[..., :, None, None].float() * freq    # (...,S,1,half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# -------------------------------------------------------------- embeddings
def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device) -> dict:
    if torch.device(device).type == "meta":
        return {"table": torch.empty((vocab, d), dtype=dtype, device=device)}
    tbl = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                      device=device)
    return {"table": tbl.to(dtype)}


def embed_axes() -> dict:
    return {"table": ("vocab", "embed")}


def embed_lookup(params: dict, tokens: torch.Tensor, *, scale: bool,
                 d: int) -> torch.Tensor:
    x = params["table"][tokens]
    if scale:
        x = x * torch.tensor(np.sqrt(d), dtype=x.dtype)    # a CPU scalar
    return x


def _card_route(x: torch.Tensor) -> bool:
    """A low-precision product takes the card's f32-out route on CUDA, and
    on meta (the dry run counts what the card runs)."""
    return x.device.type in ("cuda", "meta") and x.dtype != torch.float32


class _UnembedF32(torch.autograd.Function):
    """``torch.mm(x2, table.T, out_dtype=float32)``, which has no
    derivative, under autograd.  The backward is the upcast product's:
    each grad computed in f32 from the f32 logits' grad and rounded once
    to its operand's dtype (as the JAX package's transpose of its f32-out
    dot rounds it)."""

    @staticmethod
    def forward(ctx, x2, table):
        ctx.save_for_backward(x2, table)
        return torch.mm(x2, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, table = ctx.saved_tensors
        dx = dtable = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, table.float()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dtable = torch.mm(x2.float().t(), g).t().to(table.dtype)
        return dx, dtable


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied head: logits = x @ table.T, f32 out.

    On the card a bf16 product goes through ``torch.mm(..., out_dtype=
    float32)`` (f32 accumulation, f32 result: no bf16 rounding of the
    logits), as ``_UnembedF32`` for its backward; on the CPU, and for f32
    operands, the operands are upcast."""
    table = params["table"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _card_route(x):
        out = _UnembedF32.apply(x2, table)
    else:
        out = torch.mm(x2.float(), table.float().t())
    return out.reshape(*lead, table.shape[0])


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(x2, w, out_dtype=float32)``, which has no derivative,
    under autograd: each grad computed in f32 from the f32 result's grad
    and rounded once to its operand's dtype, as ``_UnembedF32``."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w.float().t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x2.float().t(), g).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) with an f32 result, unrounded: a tensor-parallel
    shard's partial product, summed over the shards before the one rounding
    to the model dtype.  On the card a bf16 product accumulates and returns
    in f32 (``out_dtype``; ``_MatmulF32`` under autograd); elsewhere the
    operands are upcast."""
    x2 = x.reshape(-1, x.shape[-1])
    if _card_route(x):
        out = _MatmulF32.apply(x2, w)
    else:
        out = torch.mm(x2.float(), w.float())
    return out.reshape(*x.shape[:-1], w.shape[1])


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return (cap * torch.tanh(logits / cap)).to(logits.dtype)


# ------------------------------------------------------------ initializers
def dense_init(generator: torch.Generator, shape: tuple[int, ...], dtype,
               device, *, in_axis: int = 0) -> torch.Tensor:
    """N(0, 1/fan_in) weights; on the meta device (the dry run's shapes) an
    empty tensor, drawing nothing."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device) / np.sqrt(fan_in)
    return w.to(dtype)
