"""Public wrapper of the SSD chunked-scan kernel (K3).

``ssd`` takes the JAX package's layout (``kernels/ssd/ops.py``) plus the
initial state ``h0`` that the JAX model's ``ssd_chunked`` takes.  The
tensor's device picks the path:

- a CPU tensor runs the plain PyTorch version (``ref.py``);
- a CUDA tensor launches the hand-written CUDA C++ kernel
  (``kernels/csrc/ssd.cu``, built at first use) or raises — there is no
  fallback.

Replaces the TPU kernel ``kernels/ssd/kernel.py::ssd_fwd`` (body
``_kernel``).  On the H100 it is bound by the bytes it moves (x in, f32 y
out, B, C, dt, the states); see the source note in the ``.cu`` file for
the design.  y and h_final are float32 whatever x's dtype: the Mamba-2
block adds its D-term in f32 and rounds once.

``ssd.launches`` counts kernel launches (never plain calls), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import ssd_chunked_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_P, _MAX_N = 64, 128              # 4 head columns, 8 state columns a thread

_lib_fn = None


def _kernel():
    global _lib_fn
    if _lib_fn is None:
        fn = build.load("ssd").ssd_scan
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        _lib_fn = fn
    return _lib_fn


def _check(x, dt, A, B_, C_, D, h0, chunk):
    named = {"x": x, "dt": dt, "A": A, "B_": B_, "C_": C_}
    if D is not None:
        named["D"] = D
    if h0 is not None:
        named["h0"] = h0
    for n, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{n} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if t.requires_grad:
            raise NotImplementedError(
                f"{n} requires grad: the SSD scan is forward only, as in the "
                f"JAX package; gradients come with the training slice "
                f"(ROADMAP P12)")
    if x.dtype not in _CODES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError(f"x, B_, C_ dtypes {x.dtype}/{B_.dtype}/{C_.dtype} "
                        f"must match and be one of {list(_CODES)}")
    for n in ("dt", "A", "D", "h0"):
        if n in named and named[n].dtype != torch.float32:
            raise TypeError(f"{n} must be float32, got {named[n].dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P), got {tuple(x.shape)}")
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if dt.shape != (Bb, S, H) or A.shape != (H,) or \
            B_.shape != (Bb, S, N) or C_.shape != (Bb, S, N):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B_ "
                         f"{tuple(B_.shape)}, C_ {tuple(C_.shape)} do not fit "
                         f"x {tuple(x.shape)}: want (B,S,H), (H,), (B,S,N)")
    if D is not None and D.shape != (H,):
        raise ValueError(f"D must be ({H},), got {tuple(D.shape)}")
    if h0 is not None and h0.shape != (Bb, H, P, N):
        raise ValueError(f"h0 must be {(Bb, H, P, N)}, got {tuple(h0.shape)}")
    if not (0 < P <= _MAX_P and 0 < N <= _MAX_N):
        raise ValueError(f"head_dim {P} / state {N} outside 1..{_MAX_P} / "
                         f"1..{_MAX_N}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def ssd(x, dt, A, B_, C_, D=None, *, chunk: int = 128, h0=None):
    """Chunked SSD scan.  x: (B,S,H,P) float32 or bfloat16; dt: (B,S,H)
    float32, already softplus'd; A: (H,) float32, negative; B_, C_: (B,S,N)
    in x's dtype, shared by every head; D: optional (H,) float32, added as
    ``D·x`` (the Mamba-2 block passes none and adds it itself); h0: optional
    (B,H,P,N) float32 initial state.  Returns (y (B,S,H,P), h_final
    (B,H,P,N)), both float32."""
    _check(x, dt, A, B_, C_, D, h0, chunk)
    if not x.is_cuda:
        return ssd_chunked_ref(x, dt, A, B_, C_, D, chunk=chunk, h0=h0)
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    h_final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            _CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_.data_ptr(), C_.data_ptr(),
            D.data_ptr() if D is not None else None,
            h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), h_final.data_ptr(), Bb, S, H, P, N,
            min(chunk, S) if S else 1, stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    ssd.launches += 1
    return y, h_final


ssd.launches = 0
