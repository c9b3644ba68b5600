// Split-KV attention for one query token per unit, shared by K4
// (decode_attention.cu: dense per-slot caches) and K1
// (ragged_paged_attention.cu: a paged pool through block tables), for
// Hopper (sm_90a).  K1's tensor-core kernel (bf16 q) has its own inner loop
// but writes the same per-token partials of the same spans, merged by the
// same combine; the span loop below is K1's for f32 q.
//
// The mechanism, written once:
//
// - Spans.  The key axis of a (unit, kv-head) is cut into fixed spans
//   anchored at absolute indices: K4 slots [s*C4, (s+1)*C4), K1 table blocks
//   [s*C1, (s+1)*C1).  One CTA takes one (unit, kv-head, span); the grid's
//   third axis is ceil(S / C4) or ceil(nb / C1), known from the shapes alone
//   (no host sync).  A CTA whose span holds no visible key writes an empty
//   partial (m = NEG_INF, l = 0) and returns.
//   The span lengths are runtime arguments; the wrappers pass C4 = 256 slots
//   and C1 = 32 blocks (512 positions at block 16).  Why: a served decode
//   tick has only B x K = 64 (gemma2-9b's 8 rows x 8 kv-heads) or 256
//   (zamba2-2.7b's 8 x 32) (row, kv-head) pairs, under one or two waves of
//   132 SMs.  At C4 = 256 a full 8192-slot row is 32 CTAs, so gemma2's
//   8-row case launches 2,048 CTAs (about 800 with visible slots), many
//   waves; K1's long decode row (4,532 positions, window 4,096) becomes 9
//   spans x 8 kv-heads, and the longest CTA streams 512 positions instead
//   of the whole row.  C1 is the shortest span that keeps K1's workspace
//   near 128 MiB at the served T = 512 lanes and max_len 8192.
// - Partials.  Each CTA keeps (m, l, acc) per query head in f32 and writes
//   them to an f32 workspace of (units, K, n_span, G, D) for acc plus
//   (units, K, n_span, G) each for m and l, which the wrapper allocates
//   with torch.empty and reuses across calls (the kernels allocate
//   nothing).  Size: units * K * n_span * G * (D + 2) * 4 bytes.  K1 at
//   T = 512, K = 8, G = 2, D = 256, nb = 512 (max_len 8192): 16 spans,
//   129 MiB; K4 at gemma2-9b's 8 x 8192 slots: 32 spans, 4.1 MiB.
// - The combine pass, a second small kernel: for each (unit, query head) it
//   merges the spans in span order, skipping spans with l_s == 0:
//   mm = max m_s, l = sum c_s l_s, acc = sum c_s acc_s, c_s = exp(m_s - mm).
//   The result is deterministic, and spans that hold nothing cannot change a
//   bit (so K1's output stays bit-invariant to -1 table widening).  Each
//   kernel keeps its own end case when no span holds anything (K1: exact
//   zeros; K4: the uniform average of the row's values).
// - The inner loop of a span.  8 warps; each warp splits into sub-groups of
//   LR lanes (a power of two), one key row per sub-group, lane i of a
//   sub-group holding 16-byte vectors i, i + LR, ... of the row (4-byte words
//   when a row is not a whole number of aligned 16-byte vectors), so
//   neighbouring lanes read neighbouring addresses.  A sub-group is one
//   online-softmax stream with its own f32 m, l and accumulator; streams
//   merge at the end of the span (shuffles inside a warp, shared memory
//   across warps).  Keys are taken in tiles of U rows a sub-group, and the
//   next tile's K/V loads are issued into registers before the current tile
//   is used (register prefetch: the kernels are bound by bytes, so the point
//   is to keep loads in flight, and registers need no barrier between
//   producer and consumer as a cp.async ring in shared memory would).  Each
//   loaded K/V row is dequantized once (int8 / fp8 times their f32 scales,
//   in registers) and used by every query head of the kv-head: GC heads a
//   pass, GC the power of two >= G bounded by the registers (GC x elements a
//   lane <= 64), so any G = H / K works; G > GC takes ceil(G / GC) passes
//   over the span.  Scores: scale, then the tanh softcap (tanhf); p is
//   re-masked explicitly (a wholly masked tile would otherwise emit
//   exp(0) = 1).
// - Issue slots bound this loop as much as bytes do: a lane holds only 8
//   dequantized elements of a row, so a per-row shuffle reduction, tanh
//   and exp on all 32 lanes would cost more issue slots than the row's
//   loads take.  So a tile's N = U x GC dot products are reduced
//   with a reduce-scatter: each lane ends with the whole sum of one score,
//   and computes that score's softcap and exp alone; the others receive
//   them by shuffle.  A tile in which no row is visible is skipped by the
//   whole warp, and K4 skips a span with no visible slot before it loads a
//   row.  The skips matter for K4's partly filled rows and rings.
//
// What bounds both kernels: bytes.  Each visible K/V element feeds 2 flops
// per query head of its kv-head (G <= 8 on every config), far under the
// card's ~300 flop/byte balance point.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_once.cuh"

namespace split_kv {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 256;
constexpr int REGS_QA = 64;          // GC x elements a lane, for q and acc each

// A loaded 32-bit word holds VE elements of type T.
template <typename T> struct Word;
template <> struct Word<float> {
  static constexpr int VE = 1;
  __device__ static float get(uint32_t w, int) { return __uint_as_float(w); }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int VE = 2;      // little-endian: element 0 in the low half
  __device__ static float get(uint32_t w, int e) {
    return __uint_as_float(e ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Word<int8_t> {
  static constexpr int VE = 4;
  __device__ static float get(uint32_t w, int e) {
    return static_cast<float>(static_cast<int8_t>(w >> (8 * e)));
  }
};
template <> struct Word<__nv_fp8_e4m3> {
  static constexpr int VE = 4;
  __device__ static float get(uint32_t w, int e) {
    __nv_fp8_e4m3 f;
    f.__x = static_cast<__nv_fp8_storage_t>((w >> (8 * e)) & 0xffu);
    return static_cast<float>(f);
  }
};

// The layout of one key row over a sub-group, chosen on the host.
struct Layout {
  int vb;     // bytes a vector: 16 or 4
  int vpl;    // vectors a lane: 1 or 2 (16-byte), 1 or 8 (4-byte)
  int lr;     // lanes a row: a power of two <= 32
  int gc;     // query heads a pass: 1, 2, 4 or 8
};

// Elements a lane holds of one row.
__host__ __device__ constexpr int lane_elems(int vb, int vpl, int ve) {
  return vpl * (vb / 4) * ve;
}

// Rows a sub-group loads per tile.  Two: with the next tile's loads in
// flight that is four rows a sub-group; four-row tiles take the served
// layouts to 255 registers, one CTA an SM, and run slower on the card.
constexpr int TILE_ROWS = 2;

// CTAs an SM the compiler must fit (__launch_bounds__): two (at most 128
// registers a thread) where q and the accumulator take at most 32 registers
// each, as on every served layout; one for wider ones.
template <typename KVT, int VB, int VPL, int GC>
__host__ __device__ constexpr int min_blocks() {
  return GC * lane_elems(VB, VPL, Word<KVT>::VE) <= 32 ? 2 : 1;
}

inline Layout choose_layout(int D, int item, int ve, bool aligned16, int G) {
  const int row_bytes = D * item;
  Layout L;
  L.vb = (aligned16 && row_bytes % 16 == 0) ? 16 : 4;
  const int nv = row_bytes / L.vb;
  const int need = (nv + 31) / 32;
  L.vpl = L.vb == 16 ? need : (need <= 1 ? 1 : 8);
  const int per_lane = (nv + L.vpl - 1) / L.vpl;
  L.lr = 1;
  while (L.lr < per_lane) L.lr <<= 1;
  const int elems = lane_elems(L.vb, L.vpl, ve);
  L.gc = 1;
  while (L.gc < G && L.gc < 8 && 2 * L.gc * elems <= REGS_QA) L.gc <<= 1;
  return L;
}

// Calls f(vb, vpl, gc) with std::integral_constant arguments for the layout
// L (every combination the host can choose is instantiated once).
template <typename KVT, typename F>
int with_layout(const Layout& L, F&& f) {
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  using I8 = std::integral_constant<int, 8>;
  using I16 = std::integral_constant<int, 16>;
  auto by_gc = [&](auto vb, auto vpl) -> int {
    constexpr int E = lane_elems(decltype(vb)::value, decltype(vpl)::value,
                                 Word<KVT>::VE);
    switch (L.gc) {
      case 1: return f(vb, vpl, I1{});
      case 2: if constexpr (2 * E <= REGS_QA) return f(vb, vpl, I2{}); break;
      case 4: if constexpr (4 * E <= REGS_QA) return f(vb, vpl, I4{}); break;
      case 8: if constexpr (8 * E <= REGS_QA) return f(vb, vpl, I8{}); break;
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (L.vb == 16 && L.vpl == 1) return by_gc(I16{}, I1{});
  if (L.vb == 16 && L.vpl == 2) return by_gc(I16{}, I2{});
  if (L.vb == 4 && L.vpl == 1) return by_gc(I4{}, I1{});
  if (L.vb == 4 && L.vpl == 8) return by_gc(I4{}, I8{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of span_partial: the 8 warps' merged streams.
inline size_t smem_bytes(const Layout& L, int D) {
  return static_cast<size_t>(WARPS) * L.gc * (D + 2) * sizeof(float);
}

// The workspace of partials: acc (parts, D), then m (parts), then l (parts),
// parts = units * K * n_span * G.
struct Partials {
  float* acc;
  float* m;
  float* l;
};

__device__ __forceinline__ Partials partials_at(float* ws, size_t parts,
                                                int D) {
  return {ws, ws + parts * D, ws + parts * D + parts};
}

// The empty partial of (unit, kv-head, span) base part index `part0`.
__device__ __forceinline__ void write_empty(const Partials& P, size_t part0,
                                            int G) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    P.m[part0 + g] = NEG_INF;
    P.l[part0 + g] = 0.f;
  }
}

__device__ __forceinline__ float load_q(const void* q, bool q_bf16,
                                        size_t i) {
  return q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
                : static_cast<const float*>(q)[i];
}

// One online-softmax state merged with another, the lower stream first;
// an empty state (l == 0) never changes the other.  Written without fused
// multiply-adds so that both lanes of a shuffle pair compute the same bits.
__device__ __forceinline__ void merge_scalars(float& m, float& l, float mo,
                                              float lo, float& c, float& co) {
  if (lo == 0.f) {
    c = 1.f; co = 0.f;
  } else if (l == 0.f) {
    c = 0.f; co = 1.f; m = mo; l = lo;
  } else {
    const float mm = fmaxf(m, mo);
    c = expf(m - mm);
    co = expf(mo - mm);
    l = __fadd_rn(__fmul_rn(l, c), __fmul_rn(lo, co));
    m = mm;
  }
}

__device__ __forceinline__ float score(float dot, float scale, float softcap) {
  const float s = dot * scale;
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// The online-softmax rescale of a tile: each head's new running max over
// its visible scores, and m, l and acc rescaled to it.
template <int U, int GC, int E>
__device__ __forceinline__ void online_max(const float (&sc)[U * GC],
                                           const bool (&vis)[U],
                                           float (&m)[GC], float (&mx)[GC],
                                           float (&l)[GC],
                                           float (&acc)[GC][E]) {
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    mx[g] = m[g];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (vis[u]) mx[g] = fmaxf(mx[g], sc[u * GC + g]);
    const float alpha = expf(m[g] - mx[g]);   // 0 while m is NEG_INF
    l[g] *= alpha;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] *= alpha;
    m[g] = mx[g];
  }
}

// The partial (m, l, acc) of one (unit, kv-head, span): keys
// [key0, key1) of the span, read through the source `src`:
//   src.row(key)     -> index of the key's K/V row (element row * D) and of
//                       its scales;
//   src.visible(key) -> whether the query attends to it.
// q_off: element offset of the unit's kv-head's first query head; the
// partial's base part index part0 = ((unit * K + kh) * n_span + s) * G.
template <typename KVT, bool QUANT, int VB, int VPL, int GC, typename Src>
__device__ void span_partial(const Src& src, int key0, int key1,
                             const void* q, bool q_bf16, size_t q_off,
                             const KVT* __restrict__ k,
                             const KVT* __restrict__ v,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const Partials& P, size_t part0, int G, int D,
                             int lr, float scale, float softcap) {
  using W = Word<KVT>;
  constexpr int VE = W::VE;
  constexpr int VW = VB / 4;                 // words a vector
  constexpr int E = lane_elems(VB, VPL, VE); // elements a lane
  constexpr int U = TILE_ROWS;
  using VecT = typename std::conditional<VB == 16, uint4, uint32_t>::type;
  extern __shared__ float smem[];

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int li = lane & (lr - 1), r = lane / lr, rpw = 32 / lr;
  const int nv = D * static_cast<int>(sizeof(KVT)) / VB;   // vectors a row
  const int tile = WARPS * U * rpw;                        // keys a CTA tile
  const int ntiles = (key1 - key0 + tile - 1) / tile;
  const int my0 = key0 + (w * U) * rpw + r;   // key of (tile 0, u = 0)
  float* sAcc = smem;                          // (WARPS, GC, D)
  float* sM = smem + WARPS * GC * D;           // (WARPS, GC)
  float* sL = sM + WARPS * GC;

  struct Tile {
    uint32_t kw[U][VPL][VW], vw[U][VPL][VW];
    float ks[U], vs[U];
    bool vis[U];
  };
  auto load_tile = [&](Tile& T, int it) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = my0 + it * tile + u * rpw;
      const bool vis = key < key1 && src.visible(key);
      T.vis[u] = vis;
      const size_t row = vis ? src.row(key) : 0;
      const VecT* kr = reinterpret_cast<const VecT*>(k + row * D);
      const VecT* vr = reinterpret_cast<const VecT*>(v + row * D);
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        const int j = c * lr + li;
        VecT kv{}, vv{};
        if (vis && j < nv) {
          kv = __ldg(kr + j);
          vv = __ldg(vr + j);
        }
        if constexpr (VB == 16) {
          T.kw[u][c][0] = kv.x; T.kw[u][c][1] = kv.y;
          T.kw[u][c][2] = kv.z; T.kw[u][c][3] = kv.w;
          T.vw[u][c][0] = vv.x; T.vw[u][c][1] = vv.y;
          T.vw[u][c][2] = vv.z; T.vw[u][c][3] = vv.w;
        } else {
          T.kw[u][c][0] = kv;
          T.vw[u][c][0] = vv;
        }
      }
      T.ks[u] = QUANT && vis ? __ldg(k_scale + row) : 1.f;
      T.vs[u] = QUANT && vis ? __ldg(v_scale + row) : 1.f;
    }
  };

  // scores a tile holds per sub-group, and the reduce-scatter of their dots
  // (when the sub-group has at least N lanes): the score jm a lane ends
  // with, and the lane owner[J] of its sub-group that holds score J
  constexpr int N = U * GC;
  constexpr int LOGN = N == 1 ? 0 : N == 2 ? 1 : N == 4 ? 2 : N == 8 ? 3 : 4;
  static_assert(N == 1 << LOGN, "U * GC is a power of two up to 16");
  const bool scatter = lr >= N;
  int jm = 0;
  int owner[N];
#pragma unroll
  for (int J = 0; J < N; ++J) owner[J] = r * lr;
#pragma unroll
  for (int k = 0; k < LOGN; ++k) {
    const int o = lr >> (k + 1), bit = N >> (k + 1);
    if (lane & o) jm += bit;
#pragma unroll
    for (int J = 0; J < N; ++J)
      if (J & bit) owner[J] += o;
  }

  for (int g0 = 0; g0 < G; g0 += GC) {
    const int gn = min(GC, G - g0);
    float qv[GC][E], acc[GC][E], m[GC], l[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < VPL; ++c)
#pragma unroll
        for (int x = 0; x < VW * VE; ++x) {
          const int d = (c * lr + li) * VW * VE + x;
          qv[g][c * VW * VE + x] =
              g < gn && d < D ? load_q(q, q_bf16, q_off + (g0 + g) * D + d)
                              : 0.f;
          acc[g][c * VW * VE + x] = 0.f;
        }
    }

    Tile cur, nxt;
    if (ntiles > 0) load_tile(cur, 0);
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles) load_tile(nxt, it + 1);
      bool any = false;
#pragma unroll
      for (int u = 0; u < U; ++u) any |= cur.vis[u];
      if (__any_sync(0xffffffffu, any)) {   // else the tile changes nothing
        // the sub-group's partial dots, index J = u * GC + g
        float dt[N];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float kf[E];
#pragma unroll
          for (int c = 0; c < VPL; ++c)
#pragma unroll
            for (int x = 0; x < VW; ++x)
#pragma unroll
              for (int e = 0; e < VE; ++e) {
                const float kx = W::get(cur.kw[u][c][x], e);
                kf[(c * VW + x) * VE + e] = QUANT ? kx * cur.ks[u] : kx;
              }
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < E; ++i) dot = fmaf(qv[g][i], kf[i], dot);
            dt[u * GC + g] = dot;
          }
        }
        float sc[N], pv[N], mx[GC];
        if (scatter) {
          // reduce-scatter: each lane ends with the sub-group's whole sum
          // of one score, jm, and only it takes that score's softcap
          // and exp; N - 1 + log2(lr / N) shuffles instead of
          // N log2(lr), and one tanh and exp a lane instead of N
#pragma unroll
          for (int k = 0; k < LOGN; ++k) {
            const int half = N >> (k + 1), o = lr >> (k + 1);
            const bool hi = (lane & o) != 0;
#pragma unroll
            for (int i = 0; i < half; ++i) {
              const float send = hi ? dt[i] : dt[i + half];
              const float keep = hi ? dt[i + half] : dt[i];
              dt[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
            }
          }
          for (int o = lr >> (LOGN + 1); o; o >>= 1)
            dt[0] += __shfl_xor_sync(0xffffffffu, dt[0], o);
          const float s_mine = score(dt[0], scale, softcap);
#pragma unroll
          for (int J = 0; J < N; ++J)
            sc[J] = __shfl_sync(0xffffffffu, s_mine, owner[J]);
          online_max<U, GC>(sc, cur.vis, m, mx, l, acc);
          float mx_mine = mx[0];
          bool vis_mine = cur.vis[0];
#pragma unroll
          for (int g = 1; g < GC; ++g) if (g == jm % GC) mx_mine = mx[g];
#pragma unroll
          for (int u = 1; u < U; ++u) if (u == jm / GC) vis_mine = cur.vis[u];
          // explicit re-mask: a wholly masked tile would emit exp(0) = 1
          const float p_mine = vis_mine ? expf(s_mine - mx_mine) : 0.f;
#pragma unroll
          for (int J = 0; J < N; ++J)
            pv[J] = __shfl_sync(0xffffffffu, p_mine, owner[J]);
        } else {
#pragma unroll
          for (int J = 0; J < N; ++J) {
            float dot = dt[J];
            for (int o = lr >> 1; o; o >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, o);
            sc[J] = score(dot, scale, softcap);
          }
          online_max<U, GC>(sc, cur.vis, m, mx, l, acc);
#pragma unroll
          for (int J = 0; J < N; ++J)
            pv[J] = cur.vis[J / GC] ? expf(sc[J] - mx[J % GC]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!cur.vis[u]) continue;        // the same on a sub-group's lanes
          float vf[E];
#pragma unroll
          for (int c = 0; c < VPL; ++c)
#pragma unroll
            for (int x = 0; x < VW; ++x)
#pragma unroll
              for (int e = 0; e < VE; ++e) {
                const float vx = W::get(cur.vw[u][c][x], e);
                vf[(c * VW + x) * VE + e] = QUANT ? vx * cur.vs[u] : vx;
              }
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            const float p = pv[u * GC + g];
            l[g] += p;
#pragma unroll
            for (int i = 0; i < E; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
          }
        }
      }
      cur = nxt;
    }

    // merge the warp's sub-groups, the lower sub-group first
    for (int o = 16; o >= lr; o >>= 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        float ml = upper ? mo : m[g], ll = upper ? lo : l[g];
        const float mu = upper ? m[g] : mo, lu = upper ? l[g] : lo;
        float cl, cu;
        merge_scalars(ml, ll, mu, lu, cl, cu);
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
          const float a_lo = upper ? ao : acc[g][i];
          const float a_up = upper ? acc[g][i] : ao;
          acc[g][i] = __fadd_rn(__fmul_rn(a_lo, cl), __fmul_rn(a_up, cu));
        }
        m[g] = ml;
        l[g] = ll;
      }
    }
    if (r == 0) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (li == 0) {
          sM[w * GC + g] = m[g];
          sL[w * GC + g] = l[g];
        }
#pragma unroll
        for (int c = 0; c < VPL; ++c)
#pragma unroll
          for (int x = 0; x < VW * VE; ++x) {
            const int d = (c * lr + li) * VW * VE + x;
            if (d < D) sAcc[(w * GC + g) * D + d] = acc[g][c * VW * VE + x];
          }
      }
    }
    __syncthreads();
    // merge the warps in order, as the combine pass merges spans
    for (int e = tid; e < gn * D; e += THREADS) {
      const int g = e / D, d = e - g * D;
      float mm = NEG_INF;
      for (int x = 0; x < WARPS; ++x)
        if (sL[x * GC + g] > 0.f) mm = fmaxf(mm, sM[x * GC + g]);
      float ll = 0.f, aa = 0.f;
      for (int x = 0; x < WARPS; ++x) {
        const float lx = sL[x * GC + g];
        if (lx == 0.f) continue;
        const float c = expf(sM[x * GC + g] - mm);
        ll = fmaf(c, lx, ll);
        aa = fmaf(c, sAcc[(x * GC + g) * D + d], aa);
      }
      const size_t part = part0 + g0 + g;
      P.acc[part * D + d] = aa;
      if (d == 0) {
        P.m[part] = mm;
        P.l[part] = ll;
      }
    }
    __syncthreads();
  }
}

// The ordered combine of one (unit, kv-head, query head) partial set:
// returns acc and sets l (0 when no span holds a visible key).
__device__ __forceinline__ float combine(const Partials& P, size_t part0,
                                         int n_span, int G, int D, int d,
                                         float& l) {
  float mm = NEG_INF;
  for (int s = 0; s < n_span; ++s) {
    const size_t p = part0 + static_cast<size_t>(s) * G;
    if (P.l[p] > 0.f) mm = fmaxf(mm, P.m[p]);
  }
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < n_span; ++s) {
    const size_t p = part0 + static_cast<size_t>(s) * G;
    const float ls = P.l[p];
    if (ls == 0.f) continue;
    const float c = expf(P.m[p] - mm);
    ll = fmaf(c, ls, ll);
    aa = fmaf(c, P.acc[p * D + d], aa);
  }
  l = ll;
  return aa;
}

template <typename QT> __device__ __forceinline__ QT from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// Sets the dynamic shared memory limit of `kern` once it needs over 48 KB
// (once per process and size: launch_once.cuh).
template <typename Kern>
int allow_smem(Kern kern, size_t bytes) {
  return launch_once::allow_smem(reinterpret_cast<const void*>(kern), bytes);
}

}  // namespace split_kv
