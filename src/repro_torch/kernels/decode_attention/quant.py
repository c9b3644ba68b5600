"""KV-block quantization helpers shared by the pool writers, the CUDA
kernel's plain version and the tests (port of the JAX package's
``kernels/decode_attention/quant.py``).

The paged KV pool stores blocks in one of four dtypes (``KV_DTYPES``):
``float32``/``bfloat16`` keep the unscaled layout; ``int8``/``fp8_e4m3``
add per-(block, slot, kv-head) ``float32`` scale leaves (``k_scale``/
``v_scale`` of shape ``(num_blocks, block_size, n_kv_heads)``).  Scales are
per token so a written token's bytes depend on that token alone.

Quantization is symmetric absmax over the head dim:
``scale = amax(|x|) / qmax`` per (token, kv-head), zero-guarded so an
all-zero vector round-trips to zeros with scale 1.  int8 rounds half to
even (as ``jnp.round``); fp8-e4m3 relies on the cast's rounding, which is
round-to-nearest-even in torch and in ml_dtypes alike, so the stored bytes
equal the JAX package's bit for bit.
"""
from __future__ import annotations

import torch

KV_DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")

_QUANTIZED = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
}

_UNSCALED = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_ALIASES = {
    "fp32": "float32", "f32": "float32",
    "bf16": "bfloat16",
    "fp8": "fp8_e4m3", "float8_e4m3fn": "fp8_e4m3", "e4m3": "fp8_e4m3",
}


def resolve_kv_dtype(kv_dtype: str | None) -> str | None:
    """Canonicalise a ``kv_dtype`` knob value; None passes through."""
    if kv_dtype is None:
        return None
    name = _ALIASES.get(kv_dtype, kv_dtype)
    if name not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype {kv_dtype!r} not in {KV_DTYPES} (or aliases "
            f"{sorted(_ALIASES)})")
    return name


def is_quantized(kv_dtype: str | None) -> bool:
    return resolve_kv_dtype(kv_dtype) in _QUANTIZED


def storage_dtype(kv_dtype: str | None, model_dtype: torch.dtype) -> torch.dtype:
    """The dtype pool ``k``/``v`` leaves are stored in."""
    name = resolve_kv_dtype(kv_dtype)
    if name is None:
        return model_dtype
    if name in _QUANTIZED:
        return _QUANTIZED[name][0]
    return _UNSCALED[name]


def quantize_kv(x: torch.Tensor, kv_dtype: str):
    """Quantize ``x`` (..., n_kv_heads, head_dim) → (q, scale).

    ``scale`` has shape ``x.shape[:-1]`` (one f32 scale per token per
    kv-head); ``q * scale[..., None]`` dequantizes."""
    dt, qm = _QUANTIZED[resolve_kv_dtype(kv_dtype)]
    x = x.float()
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.where(amax > 0.0, amax / qm, torch.ones_like(amax))
    scaled = x / scale[..., None]
    if dt == torch.int8:
        q = torch.clamp(torch.round(scaled), -qm, qm).to(torch.int8)
    else:
        q = torch.clamp(scaled, -qm, qm).to(dt)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: (..., K, D) × (..., K) → f32."""
    return q.float() * scale.float()[..., None]
