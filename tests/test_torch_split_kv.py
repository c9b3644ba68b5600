"""Port parity: the split-KV mechanism of K4 and K1 (spans, partials and the
ordered combine of ``kernels/csrc/split_kv.cuh``), through its plain
emulation in ``kernels/decode_attention/ref.py``, on the CPU.

The same inputs, made from numpy seeds, go through the emulation (with short
spans, so that every case has several, empty ones included), the port's
plain versions and the JAX package's refs (the TPU kernel in interpret mode
for the dense decode), at the JAX suite's f32 tolerance of 2e-5.  The CUDA
kernels are held against the plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import quant as jquant
from repro.kernels.decode_attention import ref as jref_mod
from repro.kernels.decode_attention.ops import decode_attention as jdecode
from repro_torch.kernels.decode_attention import ops, quant, ref

torch.set_num_threads(1)

_STATIC = ("window", "softcap", "scale")
jdense = jax.jit(jref_mod.decode_attention_ref, static_argnames=_STATIC)
jragged = jax.jit(jref_mod.ragged_paged_attention_ref,
                  static_argnames=_STATIC)
jragged_quant = jax.jit(jref_mod.ragged_paged_attention_quant_ref,
                        static_argnames=_STATIC)
TOL = dict(atol=2e-5, rtol=2e-5)
SPAN = 16                     # slots a K4 span in these tests (4+ spans)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _dense(B, S, H, K, D, kind, seed):
    """numpy q, caches, q_pos, cache_pos.  "partial": row b filled in slot
    order to a length past several spans, one row stopping inside the first;
    "ring": a ring of S slots wrapped past its size (slot = pos % S)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    slot = np.arange(S)[None, :]
    if kind == "partial":
        fill = np.asarray([S, 5, 2 * SPAN + 3][:B])[:, None]
        pos = np.where(slot < fill, slot, -1).astype(np.int32)
        qpos = (fill[:, 0] - 1).astype(np.int32)
    else:
        last = np.asarray([3 * S + 7, S - 1, S + 5][:B])[:, None]
        pos = last - ((last - slot) % S)
        pos = np.where(pos >= 0, pos, -1).astype(np.int32)
        qpos = last[:, 0].astype(np.int32)
    return q, k, v, qpos, pos


# (kind, window, softcap): a partial fill, a ring with a window, a softcap
DENSE_KINDS = [("partial", None, None), ("ring", 40, None),
               ("partial", None, 30.0)]


@pytest.mark.parametrize("kind,win,cap", DENSE_KINDS, ids=str)
@pytest.mark.parametrize("G", [1, 2, 4, 5, 8])
def test_dense_split_matches_plain_and_jax(G, kind, win, cap):
    B, S, K, D = 3, 90, 2, 32
    q, k, v, qpos, pos = _dense(B, S, G * K, K, D, kind, 10 * G + len(kind))
    kw = dict(window=win, softcap=cap)
    got = ref.decode_attention_split(*_t(q, k, v, qpos, pos), span=SPAN,
                                     **kw)
    plain = ops.decode_attention(*_t(q, k, v, qpos, pos), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    want = jdense(*map(jnp.asarray, (q, k, v, qpos, pos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("G", [2, 5])
def test_dense_split_quantized_matches_the_interpret_mode_kernel(G, kv_dtype):
    """int8 / fp8 caches with per-(b, slot, kv-head) scales: the emulation
    dequantizes as the kernel does in registers; held against the TPU
    kernel in interpret mode on the same bytes."""
    B, S, K, D = 3, 64, 2, 32
    q, k, v, qpos, pos = _dense(B, S, G * K, K, D, "ring", 7 + G)
    kq, ks = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(k),
                                                      kv_dtype))
    vq, vs = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(v),
                                                      kv_dtype))
    tdt = torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn
    bits = np.uint8 if kv_dtype == "fp8_e4m3" else np.int8
    kt, vt = (torch.from_numpy(a.view(bits).copy()).view(tdt)
              for a in (kq, vq))
    kw = dict(window=48, softcap=50.0)
    got = ref.decode_attention_split(
        torch.from_numpy(q), kt, vt, *_t(qpos, pos),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
        span=SPAN, **kw)
    kern = jdecode(*map(jnp.asarray, (q, kq, vq, qpos, pos)),
                   k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                   block_k=32, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    plain = ops.decode_attention(torch.from_numpy(q), kt, vt, *_t(qpos, pos),
                                 k_scale=torch.from_numpy(ks),
                                 v_scale=torch.from_numpy(vs), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_dense_split_row_with_nothing_visible_averages_its_slots():
    """Every span of row 0 empty: the combine finds l == 0 and returns the
    uniform average of the row's S values, as the plain version and the
    JAX oracle do; row 1 sees only its first slot."""
    B, S, H, K, D = 2, 40, 10, 2, 16
    q, k, v, _, _ = _dense(B, S, H, K, D, "partial", 3)
    pos = np.full((B, S), -1, np.int32)
    pos[1, 0] = 0
    qpos = np.asarray([9, 0], np.int32)
    got = ref.decode_attention_split(*_t(q, k, v, qpos, pos), span=SPAN)
    want = jdense(*map(jnp.asarray, (q, k, v, qpos, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mean = v[0].mean(axis=0).repeat(H // K, axis=0)          # (H, D)
    np.testing.assert_allclose(got[0].numpy(), mean, **TOL)
    np.testing.assert_allclose(got[1].numpy(),
                               v[1, 0].repeat(H // K, axis=0), **TOL)


def test_combine_skips_empty_spans_bit_for_bit():
    """Empty partials (m = NEG_INF, l = 0, acc = 0) inserted anywhere in the
    span order leave the combine's acc and l unchanged to the bit."""
    rng = np.random.default_rng(0)
    n, G, D = 4, 3, 8
    m = torch.from_numpy(rng.standard_normal((n, G)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 5, (n, G)).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((n, G, D)).astype(np.float32))
    a, ll = ref.combine_spans(m, l, acc)
    em = torch.full((1, G), ref.NEG_INF)
    ez, eacc = torch.zeros((1, G)), torch.zeros((1, G, D))
    for at in (0, 2, n):
        a2, l2 = ref.combine_spans(torch.cat([m[:at], em, m[at:]]),
                                   torch.cat([l[:at], ez, l[at:]]),
                                   torch.cat([acc[:at], eacc, acc[at:]]))
        assert torch.equal(a, a2) and torch.equal(ll, l2)


def test_one_span_partial_is_the_softmax():
    """A single span's partial, combined alone and normalised, is the
    softmax-weighted sum of its visible V rows."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((12, 16)).astype(np.float32))
            for _ in range(2))
    vis = torch.from_numpy(rng.random(12) < 0.6)
    vis[3] = True
    m, l, acc = ref.span_partial(q, k, v, vis, scale=0.25, softcap=None)
    a, ll = ref.combine_spans(m[None], l[None], acc[None])
    s = torch.where(vis[None], q @ k.T * 0.25, torch.tensor(ref.NEG_INF))
    want = torch.softmax(s, -1) @ v
    np.testing.assert_allclose((a / ll[:, None]).numpy(), want.numpy(), **TOL)
    m0, l0, a0 = ref.span_partial(q, k, v, torch.zeros(12, dtype=torch.bool),
                                  scale=0.25, softcap=None)
    assert bool((m0 == ref.NEG_INF).all() and (l0 == 0).all()
                and (a0 == 0).all())


# ---------------------------------------------------------------- K1
def _ragged(seed, H, K, D, bs, reqs, pads=3, extra_cols=0):
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


# (H, K, D, bs, reqs=((ctx, fed), ...), window, softcap, span blocks):
# decode rows, prefill chunks and verify rows packed together (G 1, 2, 4
# and 5), each over several spans
RAGGED_CASES = [
    (4, 2, 32, 8, ((61, 13), (64, 1), (30, 7), (8, 8)), None, 30.0, 2),
    (10, 2, 32, 8, ((50, 11), (33, 1), (9, 2)), 12, None, 1),
    (8, 8, 16, 16, ((1, 1), (2, 1), (64, 64)), None, None, 1),
    (8, 2, 32, 8, ((25, 5), (63, 3), (7, 2), (5, 1), (30, 12)), 16, 50.0, 2),
    (16, 4, 16, 4, ((40, 4), (17, 1), (23, 2)), None, None, 3),
    (10, 2, 64, 16, ((100, 36), (128, 1), (90, 2)), 20, 50.0, 2),
]


@pytest.mark.parametrize("H,K,D,bs,reqs,win,cap,span", RAGGED_CASES)
def test_ragged_split_matches_plain_and_jax(H, K, D, bs, reqs, win, cap,
                                            span):
    q, kp, vp, bt, rows, tpos, n = _ragged(H * 10 + bs, H, K, D, bs, reqs)
    kw = dict(window=win, softcap=cap)
    got = ref.ragged_paged_attention_split(*_t(q, kp, vp, bt, rows, tpos),
                                           span=span, **kw)
    plain = ops.ragged_paged_attention(*_t(q, kp, vp, bt, rows, tpos), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    want = jragged(*map(jnp.asarray, (q, kp, vp, bt, rows, tpos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bool((got[n:] == 0).all())              # pad lanes: exact zeros


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3"])
def test_ragged_split_quantized_matches_jax(kv_dtype):
    """Quantized pools: the emulation dequantizes with the per-(block, slot,
    kv-head) scales, as the kernel does in registers; held against the JAX
    package's quantized ref on the same bytes."""
    H, K, D, bs = 10, 2, 32, 8
    q, kp, vp, bt, rows, tpos, _ = _ragged(5, H, K, D, bs,
                                           ((45, 6), (33, 1), (17, 2)))
    kw = dict(window=24, softcap=50.0)
    if kv_dtype == "bfloat16":
        kd, vd = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)) for a in (kp, vp))
        got = ref.ragged_paged_attention_split(
            *_t(q, kd, vd, bt, rows, tpos), span=2, **kw)
        want = jragged(*map(jnp.asarray, (q, kd, vd, bt, rows, tpos)), **kw)
    else:
        kq, ks = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(kp),
                                                          kv_dtype))
        vq, vs = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(vp),
                                                          kv_dtype))
        tdt = torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn
        bits = np.uint8 if kv_dtype == "fp8_e4m3" else np.int8
        kt, vt = (torch.from_numpy(a.view(bits).copy()).view(tdt)
                  for a in (kq, vq))
        got = ref.ragged_paged_attention_split(
            torch.from_numpy(q), kt, vt, *_t(bt, rows, tpos),
            k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
            span=2, **kw)
        want = jragged_quant(*map(jnp.asarray, (q, kq, vq, ks, vs, bt, rows,
                                                tpos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_span_plan_and_output_are_invariant_to_widening():
    """-1 columns added to a table add only empty spans to each token's
    plan, and the emulation's output does not move by a single bit."""
    q, kp, vp, bt, rows, tpos, _ = _ragged(3, 4, 2, 16, 8,
                                           ((60, 1), (3, 1), (17, 2)), pads=1)
    wide = np.concatenate([bt, np.full((len(bt), 9), -1, np.int32)], axis=1)
    for t in range(len(tpos)):
        if rows[t] < 0:
            continue
        live = int((bt[rows[t]] >= 0).sum())
        tight_plan = ref.paged_span_plan(int(tpos[t]), live, bt.shape[1], 8,
                                         20, 2)
        wide_plan = ref.paged_span_plan(int(tpos[t]), live, wide.shape[1], 8,
                                        20, 2)
        assert wide_plan[:len(tight_plan)] == tight_plan
        assert all(p is None for p in wide_plan[len(tight_plan):])
    tight = ref.ragged_paged_attention_split(*_t(q, kp, vp, bt, rows, tpos),
                                             window=20, span=2)
    padded = ref.ragged_paged_attention_split(
        *_t(q, kp, vp, wide, rows, tpos), window=20, span=2)
    assert torch.equal(tight, padded)


def test_k0_verify_row_bitmatches_decode_in_the_split():
    """One-token rows packed out of order between pad lanes compute, span
    by span, exactly what paged decode (row_ids == arange(B)) computes."""
    H, K, D, bs = 10, 2, 32, 8
    q, kp, vp, bt, _, _, _ = _ragged(9, H, K, D, bs,
                                     ((41, 1), (9, 1), (27, 1)), pads=0)
    qpos = np.asarray([40, 8, 26], np.int32)
    decode = ref.ragged_paged_attention_split(
        *_t(q, kp, vp, bt, np.arange(3, dtype=np.int32), qpos), span=2,
        softcap=30.0)
    lanes = {1: 1, 2: 0, 4: 2}                   # lane -> request row
    qr = np.zeros((5, H, D), np.float32)
    rows = np.full(5, -1, np.int32)
    tpos = np.full(5, -1, np.int32)
    for lane, b in lanes.items():
        qr[lane], rows[lane], tpos[lane] = q[b], b, qpos[b]
    out = ref.ragged_paged_attention_split(*_t(qr, kp, vp, bt, rows, tpos),
                                           span=2, softcap=30.0)
    for lane, b in lanes.items():
        assert torch.equal(out[lane], decode[b])
    assert bool((out[[0, 3]] == 0).all())


def test_served_workspaces_stay_near_128_mib():
    """The header's sizes: K1 at the served T = 512 lanes, gemma2-9b's K = 8,
    G = 2, D = 256 and max_len 8192 (512 blocks of 16): 16 spans, about
    128 MiB; K4 at 8 rows of 8192 slots: 32 spans, about 4 MiB."""
    n1 = ref.n_spans(8192 // 16, ref.K1_SPAN_BLOCKS)
    assert n1 == 16
    assert 4 * ref.workspace_elems(512, 8, n1, 2, 256) <= 130 << 20
    n4 = ref.n_spans(8192, ref.K4_SPAN_SLOTS)
    assert n4 == 32
    assert 4 * ref.workspace_elems(8, 8, n4, 2, 256) <= 5 << 20


@pytest.mark.parametrize("H,K,D", [(40, 8, 128), (32, 8, 80), (12, 4, 64)])
def test_wrapper_checks_accept_any_gqa_group(H, K, D):
    """K4's and K1's validation take G = H / K that does not divide 8
    (llama4-maverick's 40 / 8 = 5, G = 3) as well as h2o-danube's 4."""
    B, S = 2, 32
    q = torch.zeros((B, H, D), dtype=torch.bfloat16)
    k = torch.zeros((B, S, K, D), dtype=torch.bfloat16)
    qpos = torch.zeros((B,), dtype=torch.int32)
    pos = torch.zeros((B, S), dtype=torch.int32)
    ops._check_dense(q, k, k, qpos, pos, None, None, None, None)
    pool = torch.zeros((4, 16, K, D), dtype=torch.int8)
    sc = torch.ones((4, 16, K))
    bt = torch.zeros((B, 2), dtype=torch.int32)
    ops._check(q, pool, pool, bt, qpos, qpos, sc, sc, 4096, 50.0)


def test_dense_wrapper_takes_g5_on_the_cpu():
    """llama4-maverick's widths (H 40, K 8, D 128) through the public
    wrapper's plain path, against the JAX oracle."""
    q, k, v, qpos, pos = _dense(2, 40, 40, 8, 128, "partial", 11)
    got = ops.decode_attention(*_t(q, k, v, qpos, pos))
    want = jdense(*map(jnp.asarray, (q, k, v, qpos, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quantized_emulation_uses_the_port_quantizer_bytes():
    """The port's quantizer feeds the emulation the same bytes and scales
    the JAX package's quantizer makes, so the quantized cases above hold
    for the pools the engine writes."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 2, 32)).astype(np.float32)
    for kv_dtype in ("int8", "fp8_e4m3"):
        pq, ps = quant.quantize_kv(torch.from_numpy(x), kv_dtype)
        jq, js = jquant.quantize_kv(jnp.asarray(x), kv_dtype)
        bits = torch.uint8 if kv_dtype == "fp8_e4m3" else torch.int8
        np.testing.assert_array_equal(
            pq.view(bits).numpy(),
            np.asarray(jq).view(np.uint8 if kv_dtype == "fp8_e4m3"
                                else np.int8))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
