"""Public wrappers of the decode-attention kernels: K1 (ragged paged
attention) and K4 (one-token decode attention over dense per-slot caches).

``ragged_paged_attention`` and ``decode_attention`` keep the JAX package's
layouts and signatures (``kernels/decode_attention/ops.py``).  The tensor's
device picks the path:

- a CPU tensor runs the plain PyTorch version (``ref.py``);
- a CUDA tensor launches the hand-written CUDA C++ kernel
  (``kernels/csrc/ragged_paged_attention.cu`` or
  ``kernels/csrc/decode_attention.cu``, built at first use) or raises —
  there is no fallback.

K1 replaces the TPU kernel ``kernels/decode_attention/kernel.py::
ragged_paged_attention_fwd`` (body ``_ragged_kernel``), K4 its
``decode_attention_fwd`` (body ``_kernel``).  K4 is bound by the bytes of
each row's visible cache slots, and dequantizes int8/fp8 K/V in registers.
K1 takes one of three kernels by dtypes and head shape alone
(``ragged_paged_attention_route``): a bf16 q over a bf16, int8 or fp8 pool
goes to the tensor cores, where the lanes of one request row's run share
each K/V tile (segments of at most 64 / G lanes, key tiles anchored at
absolute positions), and every lane's bits stay independent of how the
tick was packed; f32 keeps the span kernel's FMAs.  Both split the key axis
across CTAs into fixed spans (K4: ``K4_SPAN_SLOTS`` slots, K1:
``K1_SPAN_BLOCKS`` table blocks), write one f32 partial per token and span
into a workspace, and merge the spans in order in a second kernel
(``kernels/csrc/split_kv.cuh``).  The wrappers allocate that workspace, and
K1's segment plan, with ``torch.empty`` and keep them for later calls on
the same device (they only grow), so a steady-state tick allocates nothing
and needs no host sync.  See the source notes in the ``.cu`` files for the
designs.

``ragged_paged_attention.launches`` and ``decode_attention.launches`` count
wrapper calls that launched their kernels (K1's plan, span and combine
kernels count once together; plain calls never count), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build, workspace
from .ref import (K1_SPAN_BLOCKS, K4_SPAN_SLOTS, decode_attention_quant_ref,
                  decode_attention_ref, n_spans,
                  ragged_paged_attention_quant_ref, ragged_paged_attention_ref,
                  workspace_elems)

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
_QUANT_CODES = (2, 3)
_MAX_D = 256                          # register-resident rows (split_kv.cuh)
_TC_ROWS = 64                         # query rows of a K1 segment (tc::ROWS)
_SMEM_LIMIT = 232_448                 # bytes of shared memory a CTA may use

K1_ROUTES = ("tensor_core", "span", "wide")

_lib_fn = None
_route_fn = None
_dense_fn = None


def _kernel():
    global _lib_fn, _route_fn
    if _lib_fn is None:
        lib = build.load("ragged_paged_attention")
        fn = lib.ragged_paged_attention
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I, I, P, P, P, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, I, I, F, F, I, P]
        fn.restype = I
        _route_fn = lib.ragged_paged_attention_route
        _route_fn.argtypes = [I, I, I, I, I]
        _route_fn.restype = I
        _lib_fn = fn
    return _lib_fn


def ragged_paged_attention_route(q, k_pool) -> str:
    """Which of K1's kernels a CUDA call with these q and pool tensors
    launches, as the compiled library decides it (by dtypes and head shape
    alone, never by the packing): "tensor_core" (bf16 q over a bf16, int8
    or fp8 pool, head_dim a multiple of 8 up to 256, G <= 64), "span" or
    "wide".  Builds the library if needed."""
    _kernel()
    code = _route_fn(_Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], q.shape[1],
                     k_pool.shape[2], q.shape[2])
    if code < 0:
        raise ValueError(f"no K1 route for q {q.dtype}, pool {k_pool.dtype}")
    return K1_ROUTES[code]


def _check(q, k_pool, v_pool, block_tables, row_ids, token_pos, k_scale,
           v_scale, window, softcap):
    dev = q.device
    named = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
             "block_tables": block_tables, "row_ids": row_ids,
             "token_pos": token_pos}
    if k_scale is not None:
        named.update(k_scale=k_scale, v_scale=v_scale)
    for n, x in named.items():
        if x.device != dev:
            raise ValueError(f"{n} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_CODES)}")
    if k_pool.dtype not in _KV_CODES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} must "
                        f"match and be one of {list(_KV_CODES)}")
    for n in ("block_tables", "row_ids", "token_pos"):
        if named[n].dtype != torch.int32:
            raise TypeError(f"{n} must be int32, got {named[n].dtype}")
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}: want "
                         f"(T,H,D) and two (N,bs,K,D)")
    T, H, D = q.shape
    N, bs, K, Dk = k_pool.shape
    if Dk != D or H % K:
        raise ValueError(f"head_dim {D} vs pool {Dk}, or heads {H} not a "
                         f"multiple of kv heads {K}")
    if block_tables.dim() != 2 or block_tables.shape[0] == 0:
        raise ValueError(f"block_tables must be (R>0, nb), got "
                         f"{tuple(block_tables.shape)}")
    if row_ids.shape != (T,) or token_pos.shape != (T,):
        raise ValueError("row_ids and token_pos must be (T,)")
    quant = _KV_CODES[k_pool.dtype] in _QUANT_CODES
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8/fp8 pools need k_scale and v_scale; float "
                         "pools take none")
    if quant:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != (N, bs, K):
                raise ValueError(f"scales must be float32 {(N, bs, K)}, got "
                                 f"{s.dtype} {tuple(s.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    G = H // K
    if (q.dtype == torch.bfloat16 and k_pool.dtype != torch.float32
            and D % 8 == 0 and D <= _MAX_D and G <= _TC_ROWS):
        # the tensor-core path copies 16-byte pieces of q and the pools
        for n in ("q", "k_pool", "v_pool"):
            if named[n].data_ptr() % 16:
                raise ValueError(f"{n} must be 16-byte aligned")
    elif D > _MAX_D or D * k_pool.element_size() % 4:
        # rows the registers do not hold take the staged path
        smem = 4 * (2 * G * D + 2 * bs * D + G * bs + 3 * G)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"(G={G}, bs={bs}, D={D}) needs {smem} B of "
                             f"shared memory per CTA, over the {_SMEM_LIMIT} "
                             f"B limit")


def ragged_paged_attention(q, k_pool, v_pool, block_tables, row_ids,
                           token_pos, *, k_scale=None, v_scale=None,
                           window: int | None = None,
                           softcap: float | None = None,
                           scale: float | None = None):
    """Mixed prefill-chunk + decode attention over a paged KV pool.

    q: (T,H,D) packed tokens (float32 or bfloat16); pools (num_blocks,
    block_size, K, D) in float32, bfloat16, int8 or float8_e4m3fn;
    block_tables (R,nb) int32 physical block ids (-1 = unused; valid ids are
    below num_blocks); row_ids (T,) int32 request row of each packed token
    (-1 = pad lane); token_pos (T,) int32 absolute positions (-1 = pad
    lane).  ``k_scale``/``v_scale`` (num_blocks, block_size, K) float32
    accompany int8/fp8 pools.  Returns (T,H,D) in q's dtype; pad lanes are
    exact zeros."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        if k_scale is None:
            return ragged_paged_attention_ref(
                q, k_pool, v_pool, block_tables, row_ids, token_pos,
                window=window, softcap=softcap, scale=scale)
        return ragged_paged_attention_quant_ref(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, row_ids,
            token_pos, window=window, softcap=softcap, scale=scale)
    _check(q, k_pool, v_pool, block_tables, row_ids, token_pos, k_scale,
           v_scale, window, softcap)
    T, H, D = q.shape
    N, bs, K, _ = k_pool.shape
    R, nb = block_tables.shape
    out = torch.empty_like(q)
    ws = workspace(q.device, workspace_elems(
        T, K, n_spans(nb, K1_SPAN_BLOCKS), H // K, D))
    plan = workspace(q.device, 2 + 2 * T, torch.int32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            block_tables.data_ptr(), row_ids.data_ptr(), token_pos.data_ptr(),
            ws.data_ptr(), plan.data_ptr(), out.data_ptr(), T, H, K, D, R,
            nb, bs,
            K1_SPAN_BLOCKS, float(scale),
            float(softcap) if softcap is not None else 0.0,
            int(window) if window is not None else 0, stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"CUDA error {err}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def paged_decode_attention(q, k_pool, v_pool, block_tables, q_pos, *,
                           k_scale=None, v_scale=None,
                           window: int | None = None,
                           softcap: float | None = None,
                           scale: float | None = None):
    """One-token decode over a paged pool: q (B,H,D), block_tables (B,nb),
    q_pos (B,).  The ragged kernel's degenerate packing, one token per
    request: ``row_ids == arange(B)``."""
    rows = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    return ragged_paged_attention(q, k_pool, v_pool, block_tables, rows,
                                  q_pos, k_scale=k_scale, v_scale=v_scale,
                                  window=window, softcap=softcap, scale=scale)


# ================================================================ K4
def _dense_kernel():
    global _dense_fn
    if _dense_fn is None:
        fn = build.load("decode_attention").decode_attention
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I, I, P, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, F, F, I, P]
        fn.restype = I
        _dense_fn = fn
    return _dense_fn


def _check_dense(q, k_cache, v_cache, q_pos, cache_pos, k_scale, v_scale,
                 window, softcap):
    named = {"q": q, "k_cache": k_cache, "v_cache": v_cache, "q_pos": q_pos,
             "cache_pos": cache_pos}
    if k_scale is not None:
        named["k_scale"] = k_scale
    if v_scale is not None:
        named["v_scale"] = v_scale
    for n, x in named.items():
        if x.device != q.device:
            raise ValueError(f"{n} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_CODES)}")
    if k_cache.dtype not in _KV_CODES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"cache dtypes {k_cache.dtype}/{v_cache.dtype} must "
                        f"match and be one of {list(_KV_CODES)}")
    for n in ("q_pos", "cache_pos"):
        if named[n].dtype != torch.int32:
            raise TypeError(f"{n} must be int32, got {named[n].dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}: "
                         f"want (B,H,D) and two (B,S,K,D)")
    B, H, D = q.shape
    Bc, S, K, Dk = k_cache.shape
    if Bc != B or Dk != D or S == 0 or H % K:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}: same B and D, S >= 1, H a "
                         f"multiple of K")
    if q_pos.shape != (B,) or cache_pos.shape != (B, S):
        raise ValueError(f"q_pos must be ({B},) and cache_pos ({B}, {S})")
    if not 0 < D <= _MAX_D:
        raise ValueError(f"head_dim {D} must lie in 1..{_MAX_D}")
    if D * k_cache.element_size() % 4:
        raise ValueError(f"a row of head_dim {D} in {k_cache.dtype} is not a "
                         f"whole number of 32-bit words")
    quant = _KV_CODES[k_cache.dtype] in _QUANT_CODES
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8/fp8 caches need k_scale and v_scale; float "
                         "caches take none")
    if quant:
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or sc.shape != (B, S, K):
                raise ValueError(f"scales must be float32 {(B, S, K)}, got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")


def decode_attention(q, k_cache, v_cache, q_pos, cache_pos, *, k_scale=None,
                     v_scale=None, window: int | None = None,
                     softcap: float | None = None,
                     scale: float | None = None):
    """One-token decode attention.  q: (B,H,D) float32 or bfloat16; caches
    (B,S,K,D) in float32, bfloat16, int8 or float8_e4m3fn; q_pos (B,) and
    cache_pos (B,S) int32 (-1 = empty slot); ``k_scale``/``v_scale``
    (B,S,K) float32 accompany int8/fp8 caches.  Returns (B,H,D) in q's
    dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        if k_scale is None:
            return decode_attention_ref(q, k_cache, v_cache, q_pos, cache_pos,
                                        window=window, softcap=softcap,
                                        scale=scale)
        return decode_attention_quant_ref(
            q, k_cache, v_cache, k_scale, v_scale, q_pos, cache_pos,
            window=window, softcap=softcap, scale=scale)
    _check_dense(q, k_cache, v_cache, q_pos, cache_pos, k_scale, v_scale,
                 window, softcap)
    B, H, D = q.shape
    _, S, K, _ = k_cache.shape
    out = torch.empty_like(q)
    ws = workspace(q.device, workspace_elems(
        B, K, n_spans(S, K4_SPAN_SLOTS), H // K, D))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _dense_kernel()(
            _Q_CODES[q.dtype], _KV_CODES[k_cache.dtype], q.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            q_pos.data_ptr(), cache_pos.data_ptr(), ws.data_ptr(),
            out.data_ptr(), B, S, H, K, D, K4_SPAN_SLOTS, float(scale),
            float(softcap) if softcap is not None else 0.0,
            int(window) if window is not None else 0, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
