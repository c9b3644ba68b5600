"""Port parity: the plain PyTorch version of the ragged paged-attention
kernel (K1) and the KV quantizer against the JAX package's oracles.

The same inputs, made from numpy seeds, go through the JAX package's
``ref.py`` / ``quant.py`` and through the port's wrapper on CPU tensors
(which runs the plain version).  The CUDA kernel itself is held against this
plain version on the card by ``chip_smoke.py``'s kernel phase.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import quant as jquant
from repro.kernels.decode_attention import ref as jref_mod
from repro_torch.kernels.decode_attention import ops, quant, ref

torch.set_num_threads(1)

# jitted: one compile per case instead of one per eager op
_STATIC = ("window", "softcap", "scale")
jref = jax.jit(jref_mod.ragged_paged_attention_ref, static_argnames=_STATIC)
jquant_ref = jax.jit(jref_mod.ragged_paged_attention_quant_ref,
                     static_argnames=_STATIC)
jdensify = jref_mod.densify_pool

# (H, K, D, bs, reqs=((ctx, fed), ...), window, softcap): fed == 1 is a
# decode row, a longer tail a prefill chunk or a speculative verify row
# (the two are the same packing); the sweeps of tests/test_kernels.py
RAGGED_SWEEP = [
    (4, 2, 32, 8, ((25, 5), (9, 1)), None, None),
    (4, 4, 16, 16, ((33, 33), (40, 1), (17, 1)), None, None),
    (8, 2, 64, 8, ((61, 13), (64, 1), (30, 7), (8, 8)), None, 30.0),
    (2, 2, 128, 32, ((50, 11), (33, 1)), 12, None),
    (8, 8, 32, 16, ((1, 1), (2, 1), (64, 64)), None, None),
    (4, 1, 64, 64, ((100, 36), (128, 1), (90, 2)), 20, 50.0),
    (4, 2, 32, 8, ((20, 2), (33, 3), (17, 5), (9, 1)), None, None),
    (4, 4, 16, 16, ((40, 5), (16, 2), (25, 3)), None, 30.0),
    (2, 2, 64, 32, ((50, 3), (33, 5), (9, 2), (64, 1)), 12, None),
    (8, 2, 32, 8, ((25, 5), (63, 3), (7, 2), (5, 1), (30, 12)), 16, 50.0),
]

QUANT_LADDER = {                       # tests/test_kernels.py:426
    "float32": 2e-5,
    "bfloat16": 2e-2,
    "int8": 8e-2,
    "fp8_e4m3": 2.5e-1,
}

QUANT_CASES = [
    (8, ((25, 5), (9, 1)), None, None),
    (16, ((33, 33), (40, 1), (17, 1)), None, 30.0),
    (32, ((50, 11), (33, 1)), 12, None),
    (64, ((100, 4), (90, 1)), 20, 50.0),
]


def _case(seed, H, K, D, bs, reqs, pads=3, extra_cols=0):
    """numpy inputs: q, f32 pools, block tables (distinct random blocks,
    block 0 kept free), row ids and positions with ``pads`` pad lanes."""
    rng = np.random.default_rng(seed)
    ctxs = [c for c, _ in reqs]
    N = 1 + sum(-(-c // bs) for c in ctxs) + 2
    nb = max(-(-c // bs) for c in ctxs) + extra_cols
    T = sum(f for _, f in reqs) + pads
    q = rng.normal(size=(T, H, D)).astype(np.float32)
    kp = rng.normal(size=(N, bs, K, D)).astype(np.float32)
    vp = rng.normal(size=(N, bs, K, D)).astype(np.float32)
    bt = np.full((len(reqs), nb), -1, np.int32)
    perm = rng.permutation(np.arange(1, N))
    i = 0
    for r, c in enumerate(ctxs):
        n = -(-c // bs)
        bt[r, :n] = perm[i:i + n]
        i += n
    rows = np.full(T, -1, np.int32)
    tpos = np.full(T, -1, np.int32)
    n = 0
    for r, (ctx, fed) in enumerate(reqs):
        rows[n:n + fed] = r
        tpos[n:n + fed] = np.arange(ctx - fed, ctx)
        n += fed
    return q, kp, vp, bt, rows, tpos, n


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("H,K,D,bs,reqs,win,cap", RAGGED_SWEEP)
def test_plain_version_matches_jax_ref(H, K, D, bs, reqs, win, cap):
    q, kp, vp, bt, rows, tpos, n = _case(H * 100 + bs, H, K, D, bs, reqs)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(bt), jnp.asarray(rows),
                           jnp.asarray(tpos), window=win, softcap=cap))
    got = ops.ragged_paged_attention(*_t(q, kp, vp, bt, rows, tpos),
                                     window=win, softcap=cap).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert np.all(got[n:] == 0)                  # pad lanes: exact zeros


def _pool_at(kp, vp, kv_dtype):
    """JAX-quantized pool leaves (numpy) at ``kv_dtype``."""
    if kv_dtype in ("float32", "bfloat16"):
        dt = jnp.dtype(kv_dtype)
        return (np.asarray(jnp.asarray(kp).astype(dt)),
                np.asarray(jnp.asarray(vp).astype(dt)), None, None)
    kq, ks = jquant.quantize_kv(jnp.asarray(kp), kv_dtype)
    vq, vs = jquant.quantize_kv(jnp.asarray(vp), kv_dtype)
    return np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs)


def _torch_leaf(a):
    """numpy leaf (ml_dtypes bf16 / fp8 included) → CPU tensor, bitwise."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8",
                                      "fp8_e4m3"])
@pytest.mark.parametrize("bs,reqs,win,cap", QUANT_CASES)
def test_quantized_pool_matches_jax_refs(kv_dtype, bs, reqs, win, cap):
    H, K, D = 4, 2, 64
    q, kp, vp, bt, rows, tpos, n = _case(bs + len(reqs), H, K, D, bs, reqs,
                                         pads=2)
    kq, vq, ks, vs = _pool_at(kp, vp, kv_dtype)
    jargs = [jnp.asarray(a) for a in (bt, rows, tpos)]
    if ks is None:
        want = jref(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), *jargs,
                    window=win, softcap=cap)
        got = ops.ragged_paged_attention(
            torch.from_numpy(q), _torch_leaf(kq), _torch_leaf(vq),
            *_t(bt, rows, tpos), window=win, softcap=cap)
    else:
        want = jquant_ref(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                          jnp.asarray(ks), jnp.asarray(vs), *jargs,
                          window=win, softcap=cap)
        got = ops.ragged_paged_attention(
            torch.from_numpy(q), _torch_leaf(kq), _torch_leaf(vq),
            *_t(bt, rows, tpos), k_scale=_torch_leaf(ks),
            v_scale=_torch_leaf(vs), window=win, softcap=cap)
    got = got.numpy()
    # same stored values on both sides: the unquantized tolerance
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    # against the f32-pool truth: the reference's accuracy ladder
    truth = np.asarray(jref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                            *jargs, window=win, softcap=cap))
    tol = QUANT_LADDER[kv_dtype]
    np.testing.assert_allclose(got[:n], truth[:n], atol=tol, rtol=tol)
    assert np.all(got[n:] == 0)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantize_kv_bytes_match_jax_bit_for_bit(kv_dtype):
    x = np.random.default_rng(0).normal(size=(7, 8, 2, 64)).astype(np.float32)
    x[2] = 0.0                                   # all-zero rows: scale 1
    x[3] *= 300.0                                # wide range
    jq, js = jquant.quantize_kv(jnp.asarray(x), kv_dtype)
    tq, ts = quant.quantize_kv(torch.from_numpy(x), kv_dtype)
    jq = np.asarray(jq)
    bits = np.int8 if kv_dtype == "int8" else np.uint8
    tbits = tq.view(torch.uint8).numpy() if kv_dtype == "fp8_e4m3" else \
        tq.numpy()
    assert np.array_equal(jq.view(bits), tbits.view(bits))
    assert np.array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(
        quant.dequantize_kv(tq, ts).numpy(),
        np.asarray(jquant.dequantize_kv(jnp.asarray(jq), js)))


def test_kv_dtype_names_match_reference():
    assert quant.KV_DTYPES == jquant.KV_DTYPES
    for name in ("fp32", "f32", "bf16", "fp8", "float8_e4m3fn", "e4m3", None,
                 *jquant.KV_DTYPES):
        assert quant.resolve_kv_dtype(name) == jquant.resolve_kv_dtype(name)
        assert quant.is_quantized(name) == jquant.is_quantized(name)
    with pytest.raises(ValueError):
        quant.resolve_kv_dtype("int4")
    assert quant.storage_dtype("int8", torch.float32) == torch.int8
    assert quant.storage_dtype("fp8", torch.float32) == torch.float8_e4m3fn
    assert quant.storage_dtype(None, torch.bfloat16) == torch.bfloat16


def test_densify_pool_matches_jax():
    q, kp, vp, bt, rows, tpos, n = _case(1, 4, 2, 8, 4, ((9, 1), (3, 1)),
                                         extra_cols=2)
    want = jdensify(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt))
    got = ref.densify_pool(*_t(kp, vp, bt))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_widening_tables_is_bit_invariant():
    """Extra -1 columns (a wider table whose tail every row skips) must not
    change the output by a single bit."""
    q, kp, vp, bt, rows, tpos, n = _case(3, 4, 2, 64, 8,
                                         ((60, 1), (3, 1), (17, 2)), pads=1)
    tight = ops.ragged_paged_attention(*_t(q, kp, vp, bt, rows, tpos))
    wide = np.concatenate([bt, np.full((len(bt), 5), -1, np.int32)], axis=1)
    padded = ops.ragged_paged_attention(*_t(q, kp, vp, wide, rows, tpos))
    assert torch.equal(tight, padded)


def test_k0_verify_row_bitmatches_single_token_decode():
    """One-token rows packed out of slot order between pad lanes bit-match
    single-token paged decode (``row_ids == arange(B)``)."""
    H, K, D, bs = 4, 2, 32, 8
    q, kp, vp, bt, _, _, _ = _case(9, H, K, D, bs, ((21, 1), (9, 1), (17, 1)),
                                   pads=0)
    qpos = np.asarray([20, 8, 16], np.int32)
    decode = ops.paged_decode_attention(*_t(q, kp, vp, bt, qpos))
    lanes = {1: 1, 2: 0, 4: 2}                   # lane -> request row
    qr = np.zeros((5, H, D), np.float32)
    rows = np.full(5, -1, np.int32)
    tpos = np.full(5, -1, np.int32)
    for lane, b in lanes.items():
        qr[lane], rows[lane], tpos[lane] = q[b], b, qpos[b]
    out = ops.ragged_paged_attention(*_t(qr, kp, vp, bt, rows, tpos))
    for lane, b in lanes.items():
        assert torch.equal(out[lane], decode[b])
    assert torch.all(out[[0, 3]] == 0)


def test_cpu_tensors_never_count_as_kernel_launches():
    q, kp, vp, bt, rows, tpos, _ = _case(5, 4, 2, 16, 8, ((9, 2),))
    before = ops.ragged_paged_attention.launches
    ops.ragged_paged_attention(*_t(q, kp, vp, bt, rows, tpos))
    ops.paged_decode_attention(*_t(q[:1], kp, vp, bt[:1],
                                   np.asarray([8], np.int32)))
    assert ops.ragged_paged_attention.launches == before == 0
