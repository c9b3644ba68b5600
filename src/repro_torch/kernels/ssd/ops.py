"""Public wrapper of the SSD chunked-scan kernel (K3).

``ssd`` takes the JAX package's layout (``kernels/ssd/ops.py``) plus the
initial state ``h0`` that the JAX model's ``ssd_chunked`` takes.  The
tensor's device picks the path:

- a CPU tensor runs the plain PyTorch version (``ref.py``);
- a CUDA tensor launches the hand-written CUDA C++ kernels
  (``kernels/csrc/ssd.cu``, built at first use) or raises — there is no
  fallback;
- a meta tensor (the dry run) takes the explicit meta route: outputs of
  the right shapes and dtypes, and the kernels' operations and bytes
  (``work``) reported to ``kernels.record_work``.

Replaces the TPU kernel ``kernels/ssd/kernel.py::ssd_fwd`` (body
``_kernel``).  x's dtype alone picks the route (``ssd_route``): bf16 runs
the chunk-parallel stages on the tensor cores (C·Bᵀ and the chunk states,
a short sequential pass over the states, the chunk scan; f32 operands of
the products split into bf16 hi + lo), f32 the sequential FMA kernel.  The
bf16 route keeps its f32 workspace (chunk states, C·Bᵀ, cum_a:
``workspace_bytes``) in the kernels' shared scratch buffer
(``kernels.workspace``: one per device, reused by later calls), so a call
allocates only its outputs and needs no host sync.  See the source note in
the ``.cu`` file for the design.  y and h_final are float32 whatever x's
dtype: the Mamba-2 block adds its D-term in f32 and rounds once.

Gradients: the kernels are forward only, as the TPU kernel is (the JAX
package differentiates its pure-JAX chunked SSD instead).  Every call goes
through ``_SSD``, a ``torch.autograd.Function`` whose forward is the routed
call (on CUDA it launches the kernels and counts; under no_grad, or with no
operand that requires grad, it records no graph and is all there is) and
whose backward re-runs the plain version (``ref.ssd_chunked_ref``) on the
saved operands and differentiates it.

``ssd.launches`` counts calls that launched the kernels (the stages of one
call count once; plain calls never count), so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build, record_work, workspace
from .ref import ssd_chunked_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {torch.float32: "fma", torch.bfloat16: "tensor_core"}
_MAX_P, _MAX_N = 64, 128              # the kernels' padded tile widths
_ROWS = 64                            # a chunk tile's rows (Q padded to it)
_ALIGN = 64                           # floats: each workspace part 256-byte aligned

_lib_fn = None


def ssd_route(x) -> str:
    """Which of K3's kernels a CUDA call with this x launches, by dtype
    alone: "tensor_core" (bf16) or "fma" (f32)."""
    return _ROUTES[x.dtype]


def _workspace_parts(Bb, S, H, P, N, Q) -> tuple[int, int, int]:
    """Floats of the bf16 route's three workspace parts, each rounded up to
    ``_ALIGN``: chunk states (then h_prev) B·NC·H·P·N, C·Bᵀ B·NC·Qp·Qp and
    cum_a B·NC·H·Qp (NC = ceil(S/Q), Qp = Q rounded up to 64)."""
    NC = -(-S // Q)
    Qp = -(-Q // _ROWS) * _ROWS
    up = lambda n: -(-n // _ALIGN) * _ALIGN
    return (up(Bb * NC * H * P * N), up(Bb * NC * Qp * Qp),
            up(Bb * NC * H * Qp))


def workspace_bytes(x, B_, chunk: int) -> int:
    """Bytes of workspace a call with these operands uses (0 on the f32
    route)."""
    if ssd_route(x) != "tensor_core":
        return 0
    Bb, S, H, P = x.shape
    return 4 * sum(_workspace_parts(Bb, S, H, P, B_.shape[-1],
                                    min(chunk, S) if S else 1))


def work(B, S, H, P, N, Q, item, h0, D) -> tuple[int, int]:
    """(bytes, flops) one call needs at least: x read and y (f32) written,
    B_ and C_, dt, A (and D), h_final (and h0) once; per chunk of L rows
    C·Bᵀ over its causal pairs, and per head the scores' product with x
    and the inter-chunk term and state carry.  ``chip_smoke.py``'s bound
    and the meta route both count this."""
    nbytes = (B * S * H * P * (item + 4) + 2 * B * S * N * item
              + B * S * H * 4 + H * 4 * (2 if D else 1)
              + B * H * P * N * 4 * (2 if h0 else 1))
    flops = 0
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        pairs = L * (L + 1) // 2
        flops += 2 * N * pairs + H * (2 * P * pairs + 4 * L * P * N)
    return nbytes, B * flops


def _kernel():
    global _lib_fn
    if _lib_fn is None:
        fn = build.load("ssd").ssd_scan
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, P, P, P, P, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, P]
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
    # the kernel's limits; the plain version (the CPU route) also takes a
    # zero-width state (a toy SSM config's), as the reference does
    n_min = 1 if x.is_cuda else 0
    if not (0 < P <= _MAX_P and n_min <= N <= _MAX_N):
        raise ValueError(f"head_dim {P} / state {N} outside 1..{_MAX_P} / "
                         f"{n_min}..{_MAX_N}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def _launch(x, dt, A, B_, C_, D, h0, chunk):
    """The CUDA kernels on checked CUDA operands; counts the call."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S) if S else 1
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    h_final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    parts = [None, None, None]
    if ssd_route(x) == "tensor_core":
        sizes = _workspace_parts(Bb, S, H, P, N, Q)
        ws = workspace(x.device, max(sum(sizes), _ALIGN))
        offsets = (0, sizes[0], sizes[0] + sizes[1])
        parts = [ws.data_ptr() + 4 * o for o in offsets]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            _CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_.data_ptr(), C_.data_ptr(),
            D.data_ptr() if D is not None else None,
            h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), h_final.data_ptr(), *parts, Bb, S, H, P, N, Q,
            stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    ssd.launches += 1
    return y, h_final


def _routed(x, dt, A, B_, C_, D, h0, chunk):
    """The plain version for CPU tensors, the kernels for CUDA tensors, the
    kernels' count for meta tensors."""
    if x.device.type == "meta":
        Bb, S, H, P = x.shape
        N = B_.shape[-1]
        nbytes, flops = work(Bb, S, H, P, N, min(chunk, S) if S else 1,
                             x.element_size(), h0 is not None, D is not None)
        record_work("ssd", flops, nbytes)
        return (x.new_empty((Bb, S, H, P), dtype=torch.float32),
                x.new_empty((Bb, H, P, N), dtype=torch.float32))
    if not x.is_cuda:
        return ssd_chunked_ref(x, dt, A, B_, C_, D, chunk=chunk, h0=h0)
    return _launch(x, dt, A, B_, C_, D, h0, chunk)


class _SSD(torch.autograd.Function):
    """K3 under autograd: the routed forward; the backward differentiates
    the plain version re-run on the saved operands.  A grad that is not
    needed (h_final's, when only y is used) arrives as None."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, D, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B_, C_, D, h0)
        ctx.chunk = chunk
        return _routed(x, dt, A, B_, C_, D, h0, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        with torch.enable_grad():
            ops = [t if t is None else t.detach().requires_grad_()
                   for t in ctx.saved_tensors]
            y, h_final = ssd_chunked_ref(*ops[:6], chunk=ctx.chunk,
                                         h0=ops[6])
            outs, douts = zip(*[(o, g) for o, g in ((y, dy), (h_final, dh))
                                if g is not None])
            given = [t for t in ops if t is not None]
            grads = iter(torch.autograd.grad(outs, given, douts,
                                             allow_unused=True))
        return (*(None if t is None else next(grads) for t in ops), None)


def ssd(x, dt, A, B_, C_, D=None, *, chunk: int = 128, h0=None):
    """Chunked SSD scan.  x: (B,S,H,P) float32 or bfloat16; dt: (B,S,H)
    float32, already softplus'd; A: (H,) float32, negative; B_, C_: (B,S,N)
    in x's dtype, shared by every head; D: optional (H,) float32, added as
    ``D·x`` (the Mamba-2 block passes none and adds it itself); h0: optional
    (B,H,P,N) float32 initial state.  Returns (y (B,S,H,P), h_final
    (B,H,P,N)), both float32, differentiable in every operand (``_SSD``)."""
    _check(x, dt, A, B_, C_, D, h0, chunk)
    return _SSD.apply(x, dt, A, B_, C_, D, h0, chunk)


ssd.launches = 0
