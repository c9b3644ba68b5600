"""Public wrapper of the flash-attention kernel (K2).

``flash_attention`` keeps the JAX package's layout and signature
(``kernels/flash_attention/ops.py``).  The tensor's device picks the path:

- a CPU tensor runs the plain PyTorch version (``ref.py``);
- a CUDA tensor launches the hand-written CUDA C++ kernel
  (``kernels/csrc/flash_attention.cu``, built at first use) or raises —
  there is no fallback.

Replaces the TPU kernel ``kernels/flash_attention/kernel.py::
flash_attention_fwd`` (body ``_kernel``).  On the H100 it is bound by
operations (4·D·H flops per visible query-key pair); see the source note in
the ``.cu`` file for the design.  Forward only: the JAX package has no
backward for this kernel either, so an input that requires grad raises.

``flash_attention.launches`` counts kernel launches (never plain calls), so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import attention_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256                          # ceil(D/16) <= 16 columns per thread

_lib_fn = None


def _kernel():
    global _lib_fn
    if _lib_fn is None:
        fn = build.load("flash_attention").flash_attention
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I, P, P, P, P, I, I, I, I, I, F, F, I, P]
        fn.restype = I
        _lib_fn = fn
    return _lib_fn


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of one CTA at head_dim D: the f32 q tile (64,
    D+1), the K^T / V tile (D, 65) and the probabilities (64, 65)."""
    return 4 * (64 * (D + 1) + D * 65 + 64 * 65)


def _check(q, k, v, window, softcap):
    named = {"q": q, "k": k, "v": v}
    for n, x in named.items():
        if x.requires_grad:
            raise NotImplementedError(
                f"{n} requires grad: flash attention is forward only, as in "
                f"the JAX package; gradients come with the training slice "
                f"(ROADMAP P12)")
        if x.device != q.device:
            raise ValueError(f"{n} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if x.dtype != q.dtype:
            raise TypeError(f"{n} dtype {x.dtype} differs from q's {q.dtype}")
    if q.dtype not in _CODES:
        raise TypeError(f"dtype {q.dtype} not in {list(_CODES)}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B,S,H,D) and two (B,S,K,D)")
    B, S, H, D = q.shape
    if k.shape[:2] != (B, S) or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: same B, S and D, and H a "
                         f"multiple of K")
    if not 0 < D <= _MAX_D:
        raise ValueError(f"head_dim {D} outside 1..{_MAX_D}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")


def flash_attention(q, k, v, *, positions=None, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None):
    """Causal flash attention.  q: (B,S,H,D); k,v: (B,S,K,D), float32 or
    bfloat16, all one dtype.  Returns (B,S,H,D) in q's dtype.

    ``positions`` is accepted for interface parity with the JAX package, but
    like its kernel this one assumes contiguous positions 0..S-1."""
    del positions
    _check(q, k, v, window, softcap)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return attention_ref(q, k, v, window=window, softcap=softcap,
                             scale=scale)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            _CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, H, k.shape[2], D, float(scale),
            float(softcap) if softcap is not None else 0.0,
            int(window) if window is not None else 0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
