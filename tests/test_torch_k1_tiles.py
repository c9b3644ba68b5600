"""Port parity: K1's tensor-core path (``ragged_tc_kernel`` of
``kernels/csrc/ragged_paged_attention.cu``), through its plain emulation in
``kernels/decode_attention/ref.py``, on the CPU.

The plan (``ragged_segment_plan``: which lanes share a segment, and each
segment's union of visible keys per span) and the arithmetic
(``ragged_paged_attention_tiled``: key tiles anchored at multiples of KT,
each query row's own mask and online softmax in ``tile_update``, K's scale
after the dot, V's folded into p, P·V with p split into bf16 hi + lo, then
the ordered combine) are held against the port's plain version and the JAX
package's ref and interpret-mode kernel, at the JAX suite's f32 tolerance
of 2e-5 and, for int8 / fp8 pools, its quantization ladder.  The bit-exact
properties the card relies on are held exactly: every lane's output is the
same whatever lanes share its segment, -1 table widening and padding D to
a multiple of 16 change nothing, and a wholly masked tile leaves a row's
(m, l, acc) as they were.  ``chip_smoke.py`` holds the CUDA kernel itself
to the same contracts on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import quant as jquant
from repro.kernels.decode_attention import ref as jref_mod
from repro.kernels.decode_attention.ops import (
    ragged_paged_attention as jragged_kernel)
from repro_torch.kernels.decode_attention import ops, ref

torch.set_num_threads(1)

_STATIC = ("window", "softcap", "scale")
jragged = jax.jit(jref_mod.ragged_paged_attention_ref,
                  static_argnames=_STATIC)
TOL = dict(atol=2e-5, rtol=2e-5)
QUANT_LADDER = {"int8": 8e-2, "fp8_e4m3": 2.5e-1}   # tests/test_kernels.py:426


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _ragged(seed, H, K, D, bs, reqs, pads=3, extra_cols=0):
    """numpy inputs: q, f32 pools, block tables (distinct random blocks,
    block 0 kept free), row ids and positions: each row's lanes packed in
    order, then ``pads`` pad lanes."""
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


def _repack(order, *lanes):
    """The lane arrays (q, rows, tpos) re-packed so that new lane j holds
    original lane order[j] (-1: a pad lane)."""
    q, rows, tpos = lanes
    idx = np.maximum(np.asarray(order), 0)
    live = np.asarray(order) >= 0
    return (np.where(live[:, None, None], q[idx], 0).astype(np.float32),
            np.where(live, rows[idx], -1).astype(np.int32),
            np.where(live, tpos[idx], -1).astype(np.int32))


# (H, K, D, bs, reqs=((ctx, fed), ...), window, softcap, span blocks, key
# tile): decode rows, prefill chunks and verify rows packed together at
# G = 1, 2, 4 and 5, with chunks longer than a segment, several spans and
# several key tiles a span (short spans and tiles keep the CPU run small)
TILED_CASES = [
    (2, 2, 32, 8, ((90, 70), (64, 1), (30, 7)), None, 30.0, 4, 16),
    (4, 2, 32, 8, ((61, 40), (64, 1), (30, 7), (8, 8)), None, 30.0, 2, 16),
    (8, 2, 16, 4, ((40, 20), (17, 1), (23, 2)), 12, None, 4, 8),
    (10, 2, 32, 8, ((50, 30), (33, 1), (9, 2)), 12, 50.0, 2, 16),
]


@pytest.mark.parametrize("H,K,D,bs,reqs,win,cap,span,kt", TILED_CASES)
def test_tiled_matches_plain_and_jax(H, K, D, bs, reqs, win, cap, span, kt):
    q, kp, vp, bt, rows, tpos, n = _ragged(H * 10 + bs, H, K, D, bs, reqs)
    kw = dict(window=win, softcap=cap)
    got = ref.ragged_paged_attention_tiled(
        *_t(q, kp, vp, bt, rows, tpos), span=span, key_tile=kt, **kw)
    plain = ops.ragged_paged_attention(*_t(q, kp, vp, bt, rows, tpos), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    want = jragged(*map(jnp.asarray, (q, kp, vp, bt, rows, tpos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kern = jragged_kernel(*map(jnp.asarray, (q, kp, vp, bt, rows, tpos)),
                          interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    assert bool((got[n:] == 0).all())              # pad lanes: exact zeros


def test_tiled_at_the_kernels_own_tiles_and_spans():
    """The kernel's own KT (64 at D <= 128) and 32-block spans: a chunk of
    80 lanes over 300 positions at block 4 crosses three spans and several
    tiles a span."""
    H, K, D, bs = 4, 2, 32, 4
    q, kp, vp, bt, rows, tpos, n = _ragged(
        2, H, K, D, bs, ((300, 80), (257, 1), (129, 3)))
    kw = dict(window=200, softcap=50.0)
    got = ref.ragged_paged_attention_tiled(*_t(q, kp, vp, bt, rows, tpos),
                                           **kw)
    want = jragged(*map(jnp.asarray, (q, kp, vp, bt, rows, tpos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(ref.ragged_segment_plan(*_t(bt, rows, tpos), G=2, bs=bs,
                                       window=200)[0]["ranges"]) == 3


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("G", [2, 5])
def test_tiled_quantized_matches_jax(G, kv_dtype):
    """int8 / fp8 codes go into the products as they are, K's scale
    multiplies the score after the dot, V's is folded into p: held against
    the JAX package's quantized ref on the same bytes at 2e-5, and against
    the f32 pool's truth within the suite's ladder."""
    K, D, bs = 2, 32, 8
    q, kp, vp, bt, rows, tpos, n = _ragged(
        5 + G, G * K, K, D, bs, ((45, 30), (33, 1), (17, 2)))
    kq, ks = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(kp),
                                                      kv_dtype))
    vq, vs = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(vp),
                                                      kv_dtype))
    tdt = torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn
    bits = np.uint8 if kv_dtype == "fp8_e4m3" else np.int8
    kt_, vt_ = (torch.from_numpy(a.view(bits).copy()).view(tdt)
                for a in (kq, vq))
    kw = dict(window=24, softcap=50.0)
    got = ref.ragged_paged_attention_tiled(
        torch.from_numpy(q), kt_, vt_, *_t(bt, rows, tpos),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs), span=2,
        key_tile=16, **kw)
    want = jax.jit(jref_mod.ragged_paged_attention_quant_ref,
                   static_argnames=_STATIC)(
        *map(jnp.asarray, (q, kq, vq, ks, vs, bt, rows, tpos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    truth = jragged(*map(jnp.asarray, (q, kp, vp, bt, rows, tpos)), **kw)
    tol = QUANT_LADDER[kv_dtype]
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(truth)[:n],
                               atol=tol, rtol=tol)
    assert bool((got[n:] == 0).all())


# packings whose segment plans differ (G = 2: BL = 32 lanes)
PLAN_CASES = [
    ((90, 70), (64, 1), (30, 7)),                   # a chunk over 3 segments
    ((5, 5), (40, 33), (33, 1), (17, 2), (100, 64)),
    ((1, 1), (2, 1), (3, 1), (64, 64)),
]


@pytest.mark.parametrize("G", [1, 2, 4, 5])
@pytest.mark.parametrize("reqs", PLAN_CASES, ids=str)
def test_plan_puts_every_valid_lane_in_one_segment(G, reqs):
    """Every valid lane is in exactly one segment, pad lanes in none; a
    segment is one row's run of consecutive lanes at consecutive positions,
    at most BL of them, inside one BL-aligned block of positions; and it
    ends exactly where the next lane cannot join it."""
    K, bs = 2, 8
    q, kp, vp, bt, rows, tpos, n = _ragged(G, G * K, K, 16, bs, reqs)
    order = list(range(n))          # rows kept in order, one pad after row 0
    order.insert(reqs[0][1], -1)
    q, rows, tpos = _repack(order + [-1, -1], q, rows, tpos)
    bl = ref.k1_segment_lanes(G)
    assert bl == 64 // G
    seen = np.zeros(len(rows), int)
    for seg in ref.ragged_segment_plan(*_t(bt, rows, tpos), G=G, bs=bs):
        t0, cnt = seg["first"], seg["n"]
        lanes = np.arange(t0, t0 + cnt)
        seen[lanes] += 1
        assert 1 <= cnt <= bl
        assert (rows[lanes] == seg["row"]).all()
        assert (tpos[lanes] == seg["pos0"] + np.arange(cnt)).all()
        assert len(set(tpos[lanes] // bl)) == 1
        end = t0 + cnt
        assert (end == len(rows) or rows[end] != seg["row"]
                or tpos[end] != tpos[end - 1] + 1 or tpos[end] % bl == 0)
    valid = (rows >= 0) & (tpos >= 0)
    assert (seen[valid] == 1).all() and (seen[~valid] == 0).all()


def test_plan_and_output_are_invariant_to_widening():
    """-1 columns added to a table add only empty spans to each segment's
    ranges, and the emulation's output does not move by a single bit."""
    H, K, D, bs = 4, 2, 16, 8
    q, kp, vp, bt, rows, tpos, _ = _ragged(3, H, K, D, bs,
                                           ((60, 40), (3, 1), (17, 2)),
                                           pads=1)
    wide = np.concatenate([bt, np.full((len(bt), 9), -1, np.int32)], axis=1)
    tight_plan = ref.ragged_segment_plan(*_t(bt, rows, tpos), G=2, bs=bs,
                                         window=20, span=2)
    wide_plan = ref.ragged_segment_plan(*_t(wide, rows, tpos), G=2, bs=bs,
                                        window=20, span=2)
    for a, b in zip(tight_plan, wide_plan, strict=True):
        n = len(a["ranges"])
        assert b["ranges"][:n] == a["ranges"]
        assert all(r is None for r in b["ranges"][n:])
    kw = dict(window=20, span=2, key_tile=16)
    tight = ref.ragged_paged_attention_tiled(*_t(q, kp, vp, bt, rows, tpos),
                                             **kw)
    padded = ref.ragged_paged_attention_tiled(
        *_t(q, kp, vp, wide, rows, tpos), **kw)
    assert torch.equal(tight, padded)


def test_every_lane_is_bit_equal_across_packings():
    """The invariant the tensor-core path exists for: a lane's output bits
    depend only on its q, its row's table, its position and the pool, not
    on which lanes share its segment, where the segment starts, or its
    index.  The same lanes packed three ways (rows reordered with pads
    between; chunks cut at offsets that are not multiples of BL; a verify
    run taken apart into one-lane entries) give every lane the same bits,
    and the last two plans differ from the first."""
    H, K, D, bs = 4, 2, 16, 8
    q, kp, vp, bt, rows, tpos, n = _ragged(
        11, H, K, D, bs, ((120, 90), (77, 1), (64, 3), (40, 2), (9, 1)),
        pads=0)
    kw = dict(window=50, softcap=30.0, span=2, key_tile=16)
    base = ref.ragged_paged_attention_tiled(*_t(q, kp, vp, bt, rows, tpos),
                                            **kw)
    chunk, singles = list(range(90)), [90, 96]
    verify_a, verify_b = [91, 92, 93], [94, 95]
    packings = [
        [96, -1, 94, 95, -1] + chunk + [-1, 90, 91, 92, 93],
        chunk[:13] + [90] + chunk[13:45] + verify_b + chunk[45:77] + [96]
        + chunk[77:] + verify_a,
        chunk[:5] + [91] + chunk[5:40] + [94] + [92] + chunk[40:] + [90]
        + [95, 96, 93],
    ]
    def plan(r, p):
        return sorted((s["n"], s["pos0"]) for s in ref.ragged_segment_plan(
            *_t(bt, r, p), G=2, bs=bs, window=50, span=2))

    plans = []
    for order in packings:
        assert sorted(t for t in order if t >= 0) == list(range(n))
        q2, r2, p2 = _repack(order, q, rows, tpos)
        out = ref.ragged_paged_attention_tiled(*_t(q2, kp, vp, bt, r2, p2),
                                               **kw)
        for j, t in enumerate(order):
            if t >= 0:
                assert torch.equal(out[j], base[t]), (order, j, t)
            else:
                assert bool((out[j] == 0).all())
        plans.append(plan(r2, p2))
    base_plan = plan(rows, tpos)
    assert plans[0] == base_plan           # the same segments, elsewhere
    assert plans[1] != base_plan and plans[2] != base_plan


def test_k0_verify_row_bitmatches_decode_in_the_tiled_path():
    """One-token rows packed out of order between pad lanes compute exactly
    what paged decode (row_ids == arange(B)) computes for them."""
    H, K, D, bs = 10, 2, 32, 8
    q, kp, vp, bt, _, _, _ = _ragged(9, H, K, D, bs,
                                     ((41, 1), (9, 1), (27, 1)), pads=0)
    qpos = np.asarray([40, 8, 26], np.int32)
    kw = dict(softcap=30.0, span=2, key_tile=16)
    decode = ref.ragged_paged_attention_tiled(
        *_t(q, kp, vp, bt, np.arange(3, dtype=np.int32), qpos), **kw)
    lanes = {1: 1, 2: 0, 4: 2}                   # lane -> request row
    qr = np.zeros((5, H, D), np.float32)
    rows = np.full(5, -1, np.int32)
    tpos = np.full(5, -1, np.int32)
    for lane, b in lanes.items():
        qr[lane], rows[lane], tpos[lane] = q[b], b, qpos[b]
    out = ref.ragged_paged_attention_tiled(*_t(qr, kp, vp, bt, rows, tpos),
                                           **kw)
    for lane, b in lanes.items():
        assert torch.equal(out[lane], decode[b])
    assert bool((out[[0, 3]] == 0).all())


@pytest.mark.parametrize("start", ["empty", "live"])
def test_a_wholly_masked_tile_leaves_the_state_bit_identical(start):
    """A tile none of whose keys a row sees leaves that row's (m, l, acc)
    unchanged to the bit, from the start state (m = NEG_INF, where
    exp(NEG_INF - NEG_INF) must not enter) and from a live one; rows that
    do see keys of the same tile move."""
    rng = np.random.default_rng(4)
    M, KT, D = 6, 16, 8
    s = torch.from_numpy(rng.normal(size=(M, KT)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(KT, D)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.01, 0.1, KT).astype(np.float32))
    if start == "empty":
        m = torch.full((M,), ref.NEG_INF)
        l, acc = torch.zeros(M), torch.zeros((M, D))
    else:
        m = torch.from_numpy(rng.normal(size=M).astype(np.float32))
        l = torch.from_numpy(rng.uniform(1, 3, M).astype(np.float32))
        acc = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32))
    vis = torch.zeros((M, KT), dtype=torch.bool)
    vis[3, 5:9] = True                   # row 3 sees four keys, no other row
    for scale in (None, vs):
        m2, l2, a2 = ref.tile_update(m, l, acc, s, vis, v, scale)
        for r in (0, 1, 2, 4, 5):
            assert torch.equal(m2[r], m[r]) and torch.equal(l2[r], l[r])
            assert torch.equal(a2[r], acc[r])
        assert not torch.equal(a2[3], acc[3]) and bool(l2[3] > 0)


def test_padding_d_to_a_multiple_of_16_changes_nothing():
    """h2o-danube-3-4b's head_dim 120 read as 128: q and K zero-padded
    along the reduction, so Q·Kᵀ adds exact zeros and the output is the
    same to the bit."""
    H, K, D, bs = 4, 1, 120, 8
    q, kp, vp, bt, rows, tpos, _ = _ragged(6, H, K, D, bs,
                                           ((40, 20), (25, 1)))
    kw = dict(window=30, span=2, key_tile=16)
    padded = ref.ragged_paged_attention_tiled(*_t(q, kp, vp, bt, rows, tpos),
                                              **kw)
    plain = ref.ragged_paged_attention_tiled(*_t(q, kp, vp, bt, rows, tpos),
                                             pad_d=False, **kw)
    assert torch.equal(padded, plain)


def test_p_split_into_bf16_hi_and_lo_keeps_f32_precision():
    """P·V takes p as bf16 hi + lo: one tile's accumulator stays within
    2^-16 of p's size-weighted sum of |v| of the f32 product, where one
    bf16 rounding of p would err by up to 2^-9 of it."""
    rng = np.random.default_rng(5)
    M, KT, D = 8, 32, 16
    s = torch.from_numpy(rng.normal(size=(M, KT)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(KT, D)).astype(np.float32))
    vis = torch.ones((M, KT), dtype=torch.bool)
    m0 = torch.full((M,), ref.NEG_INF)
    z, za = torch.zeros(M), torch.zeros((M, D))
    m, l, acc = ref.tile_update(m0, z, za, s, vis, v)
    p = torch.exp(s - m[:, None])
    exact = p.double() @ v.double()
    bound = (p.double() @ v.double().abs()) * 2.0 ** -16
    assert bool(((acc.double() - exact).abs() <= bound + 1e-6).all())
    one = p.to(torch.bfloat16).double() @ v.double()
    assert bool(((one - exact).abs() > bound).any())


def test_segment_and_tile_sizes_follow_the_kernel():
    """BL = 64 // G query-row lanes (gemma2's G = 2: 32; danube's G = 4:
    16) and KT = 64 keys up to D = 128, 32 past it."""
    assert [ref.k1_segment_lanes(g) for g in (1, 2, 4, 5, 8)] == \
        [64, 32, 16, 12, 8]
    assert [ref.k1_key_tile(d) for d in (64, 80, 120, 128, 160, 256)] == \
        [64, 64, 64, 64, 32, 32]
