"""Public wrapper of the flash-attention kernel (K2).

``flash_attention`` keeps the JAX package's layout and signature
(``kernels/flash_attention/ops.py``).  The tensor's device picks the path:

- a CPU tensor runs the plain PyTorch version (``ref.py``);
- a CUDA tensor launches the hand-written CUDA C++ kernel
  (``kernels/csrc/flash_attention.cu``, built at first use) or raises —
  there is no fallback;
- a meta tensor (the dry run, ``launch.dryrun``) takes the explicit meta
  route: an output of the right shape and dtype, and the kernel's
  operations and bytes (``work``) reported to ``kernels.record_work``.

Replaces the TPU kernel ``kernels/flash_attention/kernel.py::
flash_attention_fwd`` (body ``_kernel``).  On the H100 it is bound by
operations (4·D·H flops per visible query-key pair); see the source note in
the ``.cu`` file for the design.  The dtype alone picks the CUDA kernel:
bf16 runs both products on the tensor cores (wgmma, TMA, head_dim a
multiple of 8 up to 256), f32 runs f32 FMAs (head_dim 1..256).
``launch_plan`` computes, in Python, the tiling and shared memory the C
entry point is given.

Gradients: the kernel is forward only, as the TPU kernel is (the JAX
package differentiates its plain XLA attention instead).  Every call goes
through ``_FlashAttention``, a ``torch.autograd.Function`` whose forward is
the routed call (on CUDA it launches the kernel and counts; under no_grad,
or with no input that requires grad, it records no graph and is all there
is) and whose backward re-runs the plain version (``ref.attention_ref``) on
the saved inputs and differentiates it.

``flash_attention.launches`` counts kernel launches (never plain calls), so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import build, record_work
from .ref import attention_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
SMEM_LIMIT = 232_448        # bytes of shared memory a CTA may opt into (H100)

_lib_fn = None


def _kernel():
    global _lib_fn
    if _lib_fn is None:
        fn = build.load("flash_attention").flash_attention
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I, P, P, P, P, I, I, I, I, I, F, F, I, I, I, I, P]
        fn.restype = I
        _lib_fn = fn
    return _lib_fn


class Plan(NamedTuple):
    """How one call is tiled on the card."""
    dp: int            # head_dim the kernel computes with (bf16: padded)
    tile_rows: int     # query rows per CTA
    stages: int        # K/V tiles in flight (bf16 ring; 1 for f32)
    smem_bytes: int    # dynamic shared memory of one CTA


def launch_plan(D: int, dtype: torch.dtype) -> Plan:
    """The launch plan of the CUDA kernel for head_dim D.

    bf16 (tensor cores): D must be a multiple of 8 (TMA's 16-byte strides)
    up to 256; the head_dim is padded to dp, a multiple of 64 (TMA fills the
    padding with zeros); a CTA holds 128 query rows in dp/64 swizzled boxes
    of 16 KB, and a ring of as many stages (at most 4) of a 64-key K and V
    tile (16 KB per box of 64 columns) as fit, plus 1 KB to align the boxes
    and 8 bytes per barrier (three per stage and one for q).

    f32 (FMAs): any D in 1..256; one 64-row CTA holds the f32 q tile (64,
    D+1), the K^T / V tile (D, 65) and the probabilities (64, 65)."""
    if dtype == torch.bfloat16:
        if D % 8 or not 0 < D <= _MAX_D:
            raise ValueError(
                f"head_dim {D}: the bf16 kernel takes a multiple of 8 up to "
                f"{_MAX_D} (TMA needs 16-byte row strides)")
        nc = -(-D // 64)                # boxes of 64 columns
        q_box, kv_box = 128 * 128, 2 * 64 * 128

        def total(stages):
            return (1024 + nc * (q_box + stages * kv_box)
                    + 8 * (3 * stages + 1))

        stages = max(s for s in range(1, 5) if total(s) <= SMEM_LIMIT)
        return Plan(64 * nc, 128, stages, total(stages))
    if not 0 < D <= _MAX_D:
        raise ValueError(f"head_dim {D} outside 1..{_MAX_D}")
    return Plan(D, 64, 1, 4 * (64 * (D + 1) + D * 65 + 64 * 65))


def visible_pairs(S: int, window: int | None) -> int:
    """Causal (query, key) pairs with i - j < window: sum_i min(i+1, w)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def work(B, S, H, K, D, window, item) -> tuple[int, int]:
    """(bytes, flops) one call needs at least: q, k, v read and out written
    once; two products of 2·D flops per visible (query, key) pair and head.
    ``chip_smoke.py``'s bound and the meta route both count this."""
    nbytes = (2 * B * S * H * D + 2 * B * S * K * D) * item
    return nbytes, 4 * D * H * B * visible_pairs(S, window)


def _check(q, k, v, window, softcap):
    named = {"q": q, "k": k, "v": v}
    for n, x in named.items():
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


def _launch(q, k, v, window, softcap, scale):
    """The CUDA kernel on checked CUDA operands; counts the launch."""
    B, S, H, D = q.shape
    plan = launch_plan(D, q.dtype)
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, k, v)):
        raise ValueError("the bf16 kernel's TMA loads want q, k and v "
                         "16-byte aligned")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            _CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, H, k.shape[2], D, float(scale),
            float(softcap) if softcap is not None else 0.0,
            int(window) if window is not None else 0, plan.dp, plan.stages,
            plan.smem_bytes, stream)
    if err != 0:
        what = ("a TMA tensor map could not be encoded" if err == 1000
                else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention kernel launch failed: {what}")
    flash_attention.launches += 1
    return out


def _routed(q, k, v, window, softcap, scale):
    """The plain version for CPU tensors, the kernel for CUDA tensors, the
    kernel's count for meta tensors."""
    if q.device.type == "meta":
        B, S, H, D = q.shape
        nbytes, flops = work(B, S, H, k.shape[2], D, window, q.element_size())
        record_work("flash_attention", flops, nbytes)
        return torch.empty_like(q)
    if not q.is_cuda:
        return attention_ref(q, k, v, window=window, softcap=softcap,
                             scale=scale)
    return _launch(q, k, v, window, softcap, scale)


class _FlashAttention(torch.autograd.Function):
    """K2 under autograd: the routed forward; the backward differentiates
    the plain version re-run on the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (window, softcap, scale)
        return _routed(q, k, v, window, softcap, scale)

    @staticmethod
    def backward(ctx, dout):
        window, softcap, scale = ctx.args
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = attention_ref(*qkv, window=window, softcap=softcap,
                                scale=scale)
            grads = torch.autograd.grad(out, qkv, dout)
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, positions=None, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None):
    """Causal flash attention.  q: (B,S,H,D); k,v: (B,S,K,D), float32 or
    bfloat16, all one dtype.  Returns (B,S,H,D) in q's dtype, differentiable
    in q, k and v (``_FlashAttention``).

    ``positions`` is accepted for interface parity with the JAX package, but
    like its kernel this one assumes contiguous positions 0..S-1."""
    del positions
    _check(q, k, v, window, softcap)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, window, softcap, scale)


flash_attention.launches = 0
