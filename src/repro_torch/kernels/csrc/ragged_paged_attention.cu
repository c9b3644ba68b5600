// Ragged paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces the TPU kernel kernels/decode_attention/kernel.py
// ragged_paged_attention_fwd (body _ragged_kernel) of the JAX package.  Each
// packed token t attends causally (kpos <= token_pos[t]) over the KV blocks
// of its request row row_ids[t], gathered through block_tables; optional
// sliding window ((qp - kpos) < window) and tanh softcap applied after the
// scale; online softmax in f32; int8 / fp8-e4m3 pools with
// per-(block, slot, kv-head) f32 scales.
//
// The route is chosen by dtypes and head shape alone, never by the packing
// (route() below):
//
// - bf16 q over a bf16, int8 or fp8 pool, head_dim a multiple of 8 up to
//   256: the tensor-core kernel, ragged_tc_kernel, for every lane (decode,
//   verify and prefill-chunk lanes alike).  This is every served path.
// - f32 q, or a bf16 q over an f32 pool: the span kernel (split_kv.cuh),
//   whose FMAs keep the f32 cases at 2e-5.
// - head dims past 256, or rows that are not whole 32-bit words: the
//   staged wide kernel inside the same span grid.
//
// All three write one f32 partial per (token, kv-head, span of `span` table
// blocks) and leave the merge to the ordered combine kernel of
// split_kv.cuh, so -1 table widening adds only empty spans.
//
// The tensor-core kernel.  What bounds the work: a prefill chunk's tokens
// all read the same keys, so read once per chunk (not once per token) the
// bytes fall far enough that the products and the softmax bound it.
// - Segments.  A plan kernel marks each valid lane that leads a segment:
//   it does unless lane t - 1 has the same row and the previous position
//   and its own position is not a multiple of BL = 64 / G.  So a segment
//   is one row's run of consecutive positions inside one BL-aligned block,
//   at most BL lanes (32 for gemma2's G = 2, 16 for h2o-danube's G = 4); a
//   decode lane is a segment of one.  Leaders claim slots of a segment list
//   with an atomic (the order does not matter), on the device: no host sync.
//   The plan kernel also writes the pad lanes' empty partials.
// - Work items.  As many CTAs as stay resident (4 warps each) claim
//   (segment, span, kv-head) items from a counter until none is left.  An
//   item's query rows are the segment's lanes x heads, lane-major, 64 rows
//   (M), warp w owning 16 (their assignment to warps rotates by item,
//   which changes no bit).  The item walks the union of its lanes' visible
//   keys in the span, bounded by the row's live-block count as the span
//   kernel's ranges are, in tiles of KT positions (64 up to D = 128, 32
//   past it) that start at multiples of KT.
// - Copies.  K and V tiles are gathered through the block table into a
//   two-stage cp.async ring in shared memory (16-byte pieces; 8-byte ones
//   for int8 / fp8, whose codes are then converted exactly to bf16 in
//   shared memory: every int8 code and e4m3 value is a bf16 value).  Keys
//   outside the segment's range are zero-filled.  q is copied once per
//   item; q and K are zero-padded along D to a multiple of 16.
// - Products.  mma.sync m16n8k16, bf16 operands from ldmatrix, f32
//   accumulators.  S = Q·Kᵀ; K's scale multiplies the score after the dot.
//   Each row keeps its own causal / window mask against its own position,
//   p is re-masked explicitly, and O += P·V takes p (times V's scale, for
//   int8 / fp8) split into bf16 hi + lo, two products into the same
//   accumulator, so p keeps f32 precision (as K2 does).
// - The invariant: a lane's output bits depend only on its q, its row's
//   table, its position and the pool, never on which lanes share its
//   segment, where the segment starts or the lane's index.  An MMA output
//   row depends on its own A row alone; the key tiles and spans are
//   anchored at absolute positions; a tile a row does not see leaves its
//   (m, l, acc) bit-identical (alpha is exactly 1, also at m = NEG_INF,
//   and p is exactly 0); and every segment, one lane or 64, runs the same
//   single stream of tiles per span.  So a k = 0 verify row computes what
//   paged decode computes, and speculative decoding's greedy streams equal
//   plain decoding's.
#include <algorithm>

#include "hopper.cuh"
#include "split_kv.cuh"

namespace {

using namespace split_kv;

// Keys are positions of a request row: block bt[pos / bs], slot pos % bs;
// row index (block * bs + slot) * K + kh.  -1 entries below the live count
// clamp to block 0 (the null block).
struct PagedSource {
  const int* bt;           // the row's block table
  int bs, K, kh, qp, window;
  __device__ size_t row(int pos) const {
    const int j = pos / bs;
    const size_t blk = static_cast<size_t>(max(__ldg(bt + j), 0));
    return (blk * bs + (pos - j * bs)) * K + kh;
  }
  __device__ bool visible(int pos) const {
    return pos <= qp && (window <= 0 || qp - pos < window);
  }
};

// The blocks [j_lo, j_hi) of span s that hold positions visible to token
// t (given its row's live-block count), or an empty range; pad lanes and
// empty spans return false before the live count is read.  Shared by the
// two span kernels; every thread of the CTA must call it.
__device__ bool span_blocks(const int* __restrict__ block_tables, int rid,
                            int qp, int R, int nb, int bs, int s, int span,
                            int window, const int*& bt, int& j_lo,
                            int& j_hi) {
  __shared__ int s_live;
  j_lo = s * span;
  j_hi = min((s + 1) * span, nb);
  if (qp >= 0) {
    j_hi = min(j_hi, qp / bs + 1);
    const int first = qp - window + 1;
    if (window > 0 && first > 0) j_lo = max(j_lo, first / bs);
  }
  if (rid < 0 || qp < 0 || j_lo >= j_hi) return false;
  bt = block_tables + static_cast<size_t>(min(rid, R - 1)) * nb;
  if (threadIdx.x == 0) s_live = 0;
  __syncthreads();
  int cnt = 0;
  for (int j = threadIdx.x; j < nb; j += blockDim.x) cnt += __ldg(bt + j) >= 0;
  for (int o = 16; o; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&s_live, cnt);
  __syncthreads();
  j_hi = min(j_hi, s_live);
  return j_lo < j_hi;
}

template <typename KVT, bool QUANT, int VB, int VPL, int GC>
__global__ void __launch_bounds__(THREADS, (min_blocks<KVT, VB, VPL, GC>()))
    ragged_span_kernel(
    const void* q, bool q_bf16, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ row_ids, const int* __restrict__ token_pos,
    float* ws, int T, int R, int nb, int bs, int K, int G, int D, int span,
    int n_span, int lr, float scale, float softcap, int window) {
  const int t = blockIdx.x, kh = blockIdx.y, s = blockIdx.z;
  const size_t parts = static_cast<size_t>(T) * K * n_span * G;
  const Partials P = partials_at(ws, parts, D);
  const size_t part0 = ((static_cast<size_t>(t) * K + kh) * n_span + s) * G;
  const int qp = token_pos[t];
  const int* bt;
  int j_lo, j_hi;
  if (!span_blocks(block_tables, row_ids[t], qp, R, nb, bs, s, span, window,
                   bt, j_lo, j_hi)) {
    write_empty(P, part0, G);
    return;
  }
  const PagedSource src{bt, bs, K, kh, qp, window};
  span_partial<KVT, QUANT, VB, VPL, GC>(
      src, j_lo * bs, j_hi * bs, q, q_bf16,
      (static_cast<size_t>(t) * K + kh) * G * D, k_pool, v_pool, k_scale,
      v_scale, P, part0, G, D, lr, scale, softcap);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Head dims past MAX_D, or rows that are not whole 32-bit words (no config
// has either): the span's blocks one at a time, each (bs, D) K and V tile
// staged in shared memory as f32, q, m, l and acc in shared memory too, so
// D is bounded only by shared memory (the limit the wrapper checks, as it
// was before the split).  Writes the same partial as ragged_span_kernel.
template <typename KVT, bool QUANT>
__global__ void __launch_bounds__(THREADS) ragged_wide_kernel(
    const void* q, bool q_bf16, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ row_ids, const int* __restrict__ token_pos,
    float* ws, int T, int R, int nb, int bs, int K, int G, int D, int span,
    int n_span, float scale, float softcap, int window) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, h = blockIdx.y, s = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t parts = static_cast<size_t>(T) * K * n_span * G;
  const Partials P = partials_at(ws, parts, D);
  const size_t part0 = ((static_cast<size_t>(t) * K + h) * n_span + s) * G;
  const int qp = token_pos[t];
  const int* bt;
  int j_lo, j_hi;
  if (!span_blocks(block_tables, row_ids[t], qp, R, nb, bs, s, span, window,
                   bt, j_lo, j_hi)) {
    write_empty(P, part0, G);
    return;
  }
  const int GD = G * D, BD = bs * D;
  float* sQ = smem;          // (G, D) query heads of this kv-head
  float* sAcc = sQ + GD;     // (G, D) unnormalised output
  float* sK = sAcc + GD;     // (bs, D) dequantized K tile
  float* sV = sK + BD;       // (bs, D) dequantized V tile
  float* sP = sV + BD;       // (G, bs) masked scores, then probabilities
  float* sM = sP + G * bs;   // (G,) running max
  float* sL = sM + G;        // (G,) running denominator
  float* sA = sL + G;        // (G,) this block's rescale factor
  const size_t q_off = (static_cast<size_t>(t) * K + h) * G * D;
  for (int e = tid; e < GD; e += THREADS) {
    sQ[e] = load_q(q, q_bf16, q_off + e);
    sAcc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }
  __syncthreads();
  auto visible = [&](int kpos) {
    return kpos <= qp && (window <= 0 || (qp - kpos) < window);
  };
  for (int j = j_lo; j < j_hi; ++j) {
    const size_t slot0 = static_cast<size_t>(max(bt[j], 0)) * bs;
    for (int e = tid; e < BD; e += THREADS) {
      const int p = e / D, d = e - p * D;
      const size_t so = (slot0 + p) * K + h;
      float kv = to_f32(k_pool[so * D + d]);
      float vv = to_f32(v_pool[so * D + d]);
      if (QUANT) {
        kv *= k_scale[so];
        vv *= v_scale[so];
      }
      sK[e] = kv;
      sV[e] = vv;
    }
    __syncthreads();
    for (int pr = warp; pr < G * bs; pr += WARPS) {
      const int g = pr / bs, p = pr - g * bs;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += sQ[g * D + d] * sK[p * D + d];
      dot = warp_sum(dot);
      if (lane == 0) {
        float sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        sP[pr] = visible(j * bs + p) ? sc : NEG_INF;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int p = lane; p < bs; p += 32) mx = fmaxf(mx, sP[g * bs + p]);
      mx = warp_max(mx);
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int p = lane; p < bs; p += 32) {
        // explicit re-mask: a wholly masked block would emit exp(0) = 1
        const float pv = visible(j * bs + p)
                             ? expf(sP[g * bs + p] - m_new) : 0.f;
        sP[g * bs + p] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[g] = alpha;
        sL[g] = alpha * sL[g] + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < GD; e += THREADS) {
      const int g = e / D, d = e - g * D;
      float pv = 0.f;
      for (int p = 0; p < bs; ++p) pv += sP[g * bs + p] * sV[p * D + d];
      sAcc[e] = sAcc[e] * sA[g] + pv;
    }
    __syncthreads();
  }
  for (int e = tid; e < GD; e += THREADS) {
    const int g = e / D;
    P.acc[(part0 + g) * D + (e - g * D)] = sAcc[e];
    if (e - g * D == 0) {
      P.m[part0 + g] = sM[g];
      P.l[part0 + g] = sL[g];
    }
  }
}

// Shared memory of ragged_wide_kernel.
inline size_t wide_smem(int G, int D, int bs) {
  return (2 * static_cast<size_t>(G) * D + 2 * static_cast<size_t>(bs) * D +
          static_cast<size_t>(G) * bs + 3 * static_cast<size_t>(G)) *
         sizeof(float);
}

// ============================================= bf16 q: the tensor-core path
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;   // query rows (lane x head) of a segment
constexpr int STAGES = 2;          // K/V tiles in the cp.async ring

// Keys a tile: 64 up to D = 128, 32 past it (the D = 256 accumulator takes
// 128 registers a thread; 32-key tiles keep two CTAs an SM).
__host__ __device__ constexpr int key_tile(int dmax) {
  return dmax <= 128 ? 64 : 32;
}

// Byte offsets of the dynamic shared memory: q (ROWS rows), the ring of
// STAGES (K tile, V tile[, K scales, V scales]) as the pool stores them,
// for int8 / fp8 the two tiles converted to bf16, and the pool row (block x
// bs + slot) of each position of the span.
// Rows of bf16 tiles are DP + 8 elements (DP = D rounded up to 16): the
// 16-byte shift per row keeps ldmatrix free of bank conflicts.
struct Smem {
  int ld;
  size_t q, stage, stage_bytes, kbuf, vbuf, rows, total;
};

__host__ __device__ inline Smem smem_layout(int D, int kt, int span, int bs,
                                            bool quant) {
  Smem L;
  L.ld = (D + 15) / 16 * 16 + 8;
  const size_t tile16 = static_cast<size_t>(kt) * L.ld * 2;
  const size_t stored = quant ? static_cast<size_t>(kt) * D : tile16;
  L.q = 0;
  L.stage = static_cast<size_t>(ROWS) * L.ld * 2;
  L.stage_bytes = 2 * stored + (quant ? 2 * sizeof(float) * kt : 0);
  L.kbuf = L.stage + STAGES * L.stage_bytes;
  L.vbuf = L.kbuf + (quant ? tile16 : 0);
  L.rows = L.vbuf + (quant ? tile16 : 0);
  L.total = L.rows + sizeof(int) * span * bs;
  return L;
}

// Lane t of a valid run continues the segment of lane t - 1: same row,
// the next position, and not at a multiple of bl (so a segment holds at
// most bl lanes, anchored like the key tiles).
__device__ __forceinline__ bool follows(const int* row_ids,
                                        const int* token_pos, int t, int bl) {
  const int p = token_pos[t];
  return t > 0 && p % bl != 0 && row_ids[t - 1] == row_ids[t] &&
         token_pos[t - 1] == p - 1;
}

// The plan: plan[0] = segments, plan[1] = the work counter (both zeroed
// before the launch), then (first lane, lanes) of each segment in the order
// their leaders claimed them.  Also writes the empty partials of the pad
// lanes, which no segment holds.  One thread per lane and per partial.
__global__ void __launch_bounds__(256) ragged_tc_plan_kernel(
    const int* __restrict__ row_ids, const int* __restrict__ token_pos,
    int* plan, float* ws, int T, int K, int G, int D, int n_span, int bl) {
  const size_t parts = static_cast<size_t>(T) * K * n_span * G;
  const Partials P = partials_at(ws, parts, D);
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < parts) {
    const int t = static_cast<int>(i / (static_cast<size_t>(K) * n_span * G));
    if (row_ids[t] < 0 || token_pos[t] < 0) {
      P.m[i] = NEG_INF;
      P.l[i] = 0.f;
    }
  }
  if (i < static_cast<size_t>(T)) {
    const int t = static_cast<int>(i);
    if (row_ids[t] >= 0 && token_pos[t] >= 0 &&
        !follows(row_ids, token_pos, t, bl)) {
      int n = 1;
      while (t + n < T && follows(row_ids, token_pos, t + n, bl)) ++n;
      const int at = atomicAdd(plan, 1);
      plan[2 + 2 * at] = t;
      plan[3 + 2 * at] = n;
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x = hi + lo + (error <= 2^-16 |x|): the two bf16 halves of P·V's A
// operand, so that the product keeps p at f32 precision.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// Four int8 codes of a word as two bf16 pairs, exactly: byte b, biased to
// b ^ 0x80, set into the mantissa of 2^23 is the float 2^23 + 128 + code;
// subtracting 2^23 + 128 leaves the code (no int-to-float conversion).
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo,
                                              uint32_t& hi, const int8_t*) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) -
           8388736.f;
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

// Four fp8-e4m3 values as two bf16 pairs, exactly (e4m3 -> f16 -> f32 ->
// bf16 loses nothing: every e4m3 value is a bf16 value).
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo,
                                              uint32_t& hi,
                                              const __nv_fp8_e4m3*) {
  const __half2 a(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3));
  const __half2 b(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3));
  const float2 fa = __half22float2(a), fb = __half22float2(b);
  lo = pack_bf16(fa.x, fa.y);
  hi = pack_bf16(fb.x, fb.y);
}

// op-reduction of the first 2H values of v as a tree (H a power of two);
// the order is fixed, the same for every row.  Recursion on H, so that
// every index is a constant and v stays in registers.
template <int H, int N, typename Op>
__device__ __forceinline__ float tree(float (&v)[N], Op op) {
#pragma unroll
  for (int i = 0; i < H; ++i) v[i] = op(v[i], v[i + H]);
  if constexpr (H > 1) return tree<H / 2>(v, op);
  return v[0];
}

// One CTA of 4 warps claims work items (segment, span, kv-head) from the
// plan's counter until none is left.  Each warp owns 16 of the segment's
// query rows (row r = lane i x G + head g; which 16 rotates with the item,
// so that decode items spread over the SM's schedulers: no bit depends on
// it); each row keeps its own online softmax over the span's key tiles,
// which start at multiples of KT.
template <typename KVT, bool QUANT, int DMAX>
__global__ void __launch_bounds__(THREADS, 2) ragged_tc_kernel(
    const bf16* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ row_ids, const int* __restrict__ token_pos,
    int* plan, float* ws, int T, int H, int R, int nb, int bs, int K, int G,
    int D, int span, int n_span, float scale, float softcap, int window) {
  using hopper::cp_async;
  constexpr int KT = key_tile(DMAX);
  constexpr int ST = KT / 8;           // n8 tiles of a score block
  constexpr int NP = DMAX / 16;        // k16 steps of Q·Kᵀ, n16 pairs of P·V
  constexpr int CB = QUANT ? 8 : 16;   // bytes a cp.async of K / V (8 elems)
  // copies and conversions go row by row: CPM pieces of 8 elements (WPM
  // words of 4 codes) a row, a power of two, so a thread keeps its column
  constexpr int CPM = DMAX / 8, RPP = THREADS / CPM;
  constexpr int WPM = DMAX / 4, WRP = THREADS / WPM;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  __shared__ int s_item, s_live;
  const Smem L = smem_layout(D, KT, span, bs, QUANT);
  const int ld = L.ld, dp = ld - 8, np = dp / 16, cpr = D / 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  int* sRow = reinterpret_cast<int*>(smem + L.rows);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int cc = tid % CPM, cr = tid / CPM;   // this thread's piece and row
  const size_t parts = static_cast<size_t>(T) * K * n_span * G;
  const Partials P = partials_at(ws, parts, D);
  const size_t stored = QUANT ? static_cast<size_t>(KT) * D
                              : static_cast<size_t>(KT) * ld * 2;
  // stage st: K at stage_k(st), V at + stored, then K's and V's scales
  unsigned char* const ring = smem + L.stage;
  const size_t stage_bytes = L.stage_bytes;
  const auto stage_k = [ring, stage_bytes](int st) {
    return ring + st * stage_bytes;
  };
  const auto stage_v = [ring, stage_bytes, stored](int st) {
    return ring + st * stage_bytes + stored;
  };
  const auto stage_ks = [ring, stage_bytes, stored](int st) {
    return reinterpret_cast<float*>(ring + st * stage_bytes + 2 * stored);
  };
  const auto stage_vs = [ring, stage_bytes, stored](int st) {
    return reinterpret_cast<float*>(ring + st * stage_bytes + 2 * stored) +
           KT;
  };

  // columns [D, DP) of q and of the bf16 K / V tiles stay zero: the
  // copies never write them, and Q·Kᵀ reads them (zeros add exact zeros)
  if (dp > D) {
    const int pc = dp - D;
    for (int e = tid; e < ROWS * pc; e += THREADS)
      sQ[(e / pc) * ld + D + e % pc] = __float2bfloat16(0.f);
    const int nbuf = QUANT ? 2 : 2 * STAGES;
    for (int e = tid; e < nbuf * KT * pc; e += THREADS) {
      const int b = e / (KT * pc), x = e % (KT * pc);
      bf16* buf = reinterpret_cast<bf16*>(
          QUANT ? smem + (b ? L.vbuf : L.kbuf)
                : (b & 1 ? stage_v(b >> 1) : stage_k(b >> 1)));
      buf[(x / pc) * ld + D + x % pc] = __float2bfloat16(0.f);
    }
  }

  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const int n_items = plan[0] * n_span * K;
  for (;;) {
    __syncthreads();                  // the previous item's reads are done
    if (tid == 0) s_item = atomicAdd(plan + 1, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) break;
    const int seg = item / (n_span * K), rem = item - seg * n_span * K;
    const int s = rem / K, kh = rem - s * K;
    const int t0 = plan[2 + 2 * seg], n = plan[3 + 2 * seg];
    const int p0 = token_pos[t0], nG = n * G;
    const int* bt =
        block_tables + static_cast<size_t>(min(row_ids[t0], R - 1)) * nb;
    const int j0 = s * span, j1 = min(j0 + span, nb), span_lo = j0 * bs;
    // the union of the segment's visible keys in this span: [lo, hi)
    int lo = span_lo, hi = min(j1 * bs, p0 + n), kend = 0;
    if (window > 0) lo = max(lo, p0 - window + 1);
    if (lo < hi) {
      if (tid == 0) s_live = 0;
      __syncthreads();
      int cnt = 0;
      for (int j = tid; j < nb; j += THREADS) cnt += __ldg(bt + j) >= 0;
      for (int o = 16; o; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
      if (lane == 0 && cnt) atomicAdd(&s_live, cnt);
      for (int i = tid; i < (j1 - j0) * bs; i += THREADS)
        sRow[i] = max(__ldg(bt + j0 + i / bs), 0) * bs + i % bs;
      __syncthreads();
      kend = min(j1 * bs, s_live * bs);
      hi = min(hi, kend);
    }
    if (lo >= hi) {                   // nothing visible: empty partials
      for (int e = tid; e < nG; e += THREADS) {
        const size_t part =
            ((static_cast<size_t>(t0 + e / G) * K + kh) * n_span + s) * G +
            e % G;
        P.m[part] = NEG_INF;
        P.l[part] = 0.f;
      }
      continue;
    }

    auto issue_tile = [&](int tile, int st) {
      unsigned char* dk = stage_k(st);
      unsigned char* dv = stage_v(st);
      const int pitch = QUANT ? D : ld * 2;
#pragma unroll
      for (int i = 0; i < KT / RPP; ++i) {
        const int kr = cr + i * RPP, pos = tile * KT + kr;
        const bool in = pos >= lo && pos < hi;
        const size_t el =
            in ? (static_cast<size_t>(sRow[pos - span_lo]) * K + kh) * D +
                     cc * 8
               : 0;
        if (cc < cpr) {
          cp_async<CB>(dk + kr * pitch + cc * CB, k_pool + el, in);
          cp_async<CB>(dv + kr * pitch + cc * CB, v_pool + el, in);
        }
      }
      if constexpr (QUANT) {
        if (tid < KT) {
          const int pos = tile * KT + tid;
          const bool in = pos >= lo && pos < hi;
          const size_t row =
              in ? static_cast<size_t>(sRow[pos - span_lo]) * K + kh : 0;
          cp_async<4>(stage_ks(st) + tid, k_scale + row, in);
          cp_async<4>(stage_vs(st) + tid, v_scale + row, in);
        }
      }
    };

    // q rows of the segment (zero past them), in the first tile's group
#pragma unroll 4
    for (int r = cr; r < ROWS; r += RPP) {
      const bool in = r < nG;
      const size_t el =
          in ? (static_cast<size_t>(t0 + r / G) * H + kh * G + r % G) * D +
                   cc * 8
             : 0;
      if (cc < cpr) cp_async<16>(sQ + r * ld + cc * 8, q + el, in);
    }
    const int tlo = lo / KT, ntiles = (hi - 1) / KT - tlo + 1;
    issue_tile(tlo, 0);
    hopper::cp_async_commit();

    // this thread's rows r0 (acc[.][0..1]) and r1 (acc[.][2..3]), their
    // positions (-1: a pad row past the segment, which sees nothing), and
    // the warp's first and last position
    const int rg = (w + item) & (WARPS - 1);
    const int r0 = rg * 16 + (lane >> 2), r1 = r0 + 8;
    const int qp0 = r0 < nG ? p0 + r0 / G : -1;
    const int qp1 = r1 < nG ? p0 + r1 / G : -1;
    // each row's visible keys in this span: [vlo, vhi)
    const int vlo0 = window > 0 ? max(span_lo, qp0 - window + 1) : span_lo;
    const int vlo1 = window > 0 ? max(span_lo, qp1 - window + 1) : span_lo;
    const int vhi0 = min(kend, qp0 + 1), vhi1 = min(kend, qp1 + 1);
    const bool warp_rows = rg * 16 < nG;
    const int qa = p0 + (rg * 16) / G;
    const int qb = p0 + min(rg * 16 + 15, nG - 1) / G;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float acc[2 * NP][4];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      hopper::cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < ntiles) issue_tile(tlo + it + 1, (it + 1) % STAGES);
      hopper::cp_async_commit();
      const int st = it % STAGES, kb = (tlo + it) * KT;
      const bf16* tK;
      const bf16* tV;
      if constexpr (QUANT) {
        // codes are exact in bf16: convert them, and scale after the
        // products (K: the score; V: folded into p)
        const int wpr = D / 4, c = tid % WPM;
        if (c < wpr) {
#pragma unroll 4
          for (int kr = tid / WPM; kr < 2 * KT; kr += WRP) {
            const int b = kr >= KT, r = kr - b * KT;
            const uint32_t wd = reinterpret_cast<const uint32_t*>(
                b ? stage_v(st) : stage_k(st))[r * wpr + c];
            uint2 o;
            codes_to_bf16(wd, o.x, o.y, static_cast<const KVT*>(nullptr));
            *reinterpret_cast<uint2*>(smem + (b ? L.vbuf : L.kbuf) +
                                      (static_cast<size_t>(r) * ld + 4 * c) *
                                          2) = o;
          }
        }
        __syncthreads();
        tK = reinterpret_cast<const bf16*>(smem + L.kbuf);
        tV = reinterpret_cast<const bf16*>(smem + L.vbuf);
      } else {
        tK = reinterpret_cast<const bf16*>(stage_k(st));
        tV = reinterpret_cast<const bf16*>(stage_v(st));
      }
      // keys [k0, k1) of the tile that any row may see; a tile none of the
      // warp's rows sees would change nothing, so the warp skips it
      const int k0 = max(kb, span_lo), k1 = min(kb + KT, kend);
      if (!warp_rows || k0 >= k1 || k0 > qb ||
          (window > 0 && qa - (k1 - 1) >= window))
        continue;

      float S[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j) S[j][0] = S[j][1] = S[j][2] = S[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NP; ++ks) {
        if (ks < np) {
          uint32_t a[4];
          hopper::ldmatrix_x4(
              a, sQ + (rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                     ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < ST / 2; ++j) {
            uint32_t b[4];
            hopper::ldmatrix_x4(
                b, tK + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                       ks * 16 + ((lane >> 3) & 1) * 8);
            hopper::mma_bf16_16816(S[2 * j], a, b[0], b[1]);
            hopper::mma_bf16_16816(S[2 * j + 1], a, b[2], b[3]);
          }
        }
      }
      // scores, each row's own mask (bit j * 4 + e), the running max
      uint32_t vis = 0;
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = j * 8 + 2 * (lane & 3) + (e & 1), pos = kb + kr;
          float dot = S[j][e];
          if constexpr (QUANT) dot *= stage_ks(st)[kr];
          const bool v = e < 2 ? pos >= vlo0 && pos < vhi0
                               : pos >= vlo1 && pos < vhi1;
          // computed for every key, then selected: no divergent branch
          float sc = dot * scale;
          if (softcap > 0.f) sc = softcap * tanhf(sc * inv_cap);
          S[j][e] = v ? sc : NEG_INF;
          vis |= static_cast<uint32_t>(v) << (j * 4 + e);
        }
      float t0v[2 * ST], t1v[2 * ST];
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        t0v[2 * j] = S[j][0];
        t0v[2 * j + 1] = S[j][1];
        t1v[2 * j] = S[j][2];
        t1v[2 * j + 1] = S[j][3];
      }
      const auto max_op = [](float a, float b) { return fmaxf(a, b); };
      const auto add_op = [](float a, float b) { return a + b; };
      float mx0 = tree<ST>(t0v, max_op), mx1 = tree<ST>(t1v, max_op);
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row the tile does not reach keeps m: alpha is exactly 1 (also
      // at m = NEG_INF, where exp(NEG_INF - NEG_INF) must not enter)
      const float al0 = mn0 == m0 ? 1.f : expf(m0 - mn0);
      const float al1 = mn1 == m1 ? 1.f : expf(m1 - mn1);
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // explicit re-mask: a masked key is exactly 0, never exp(0)
          const float ex = expf(S[j][e] - (e < 2 ? mn0 : mn1));
          S[j][e] = (vis >> (j * 4 + e)) & 1u ? ex : 0.f;
        }
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        t0v[2 * j] = S[j][0];
        t0v[2 * j + 1] = S[j][1];
        t1v[2 * j] = S[j][2];
        t1v[2 * j + 1] = S[j][3];
      }
      float sum0 = tree<ST>(t0v, add_op), sum1 = tree<ST>(t1v, add_op);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
      if (al0 != 1.f || al1 != 1.f) {
#pragma unroll
        for (int j = 0; j < 2 * NP; ++j) {
          acc[j][0] *= al0;
          acc[j][1] *= al0;
          acc[j][2] *= al1;
          acc[j][3] *= al1;
        }
      }
      // O += P·V with p (times V's scale) split into bf16 hi + lo
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        float pv[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int j = 2 * kk + (x >> 2), e = x & 3;
          pv[x] = S[j][e];
          if constexpr (QUANT)
            pv[x] *= stage_vs(st)[j * 8 + 2 * (lane & 3) + (e & 1)];
        }
        uint32_t ah[4], al[4];
        split_bf16(pv[0], pv[1], ah[0], al[0]);
        split_bf16(pv[2], pv[3], ah[1], al[1]);
        split_bf16(pv[4], pv[5], ah[2], al[2]);
        split_bf16(pv[6], pv[7], ah[3], al[3]);
        // two column pairs at a time, the hi products before the lo ones
        const bf16* vrow =
            tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
            (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NP; j += 2) {
          if (j < np) {
            const bool two = j + 1 < np;
            uint32_t b[2][4];
            hopper::ldmatrix_x4_trans(b[0], vrow + j * 16);
            if (two) hopper::ldmatrix_x4_trans(b[1], vrow + (j + 1) * 16);
            hopper::mma_bf16_16816(acc[2 * j], ah, b[0][0], b[0][1]);
            hopper::mma_bf16_16816(acc[2 * j + 1], ah, b[0][2], b[0][3]);
            if (two) {
              hopper::mma_bf16_16816(acc[2 * j + 2], ah, b[1][0], b[1][1]);
              hopper::mma_bf16_16816(acc[2 * j + 3], ah, b[1][2], b[1][3]);
            }
            hopper::mma_bf16_16816(acc[2 * j], al, b[0][0], b[0][1]);
            hopper::mma_bf16_16816(acc[2 * j + 1], al, b[0][2], b[0][3]);
            if (two) {
              hopper::mma_bf16_16816(acc[2 * j + 2], al, b[1][0], b[1][1]);
              hopper::mma_bf16_16816(acc[2 * j + 3], al, b[1][2], b[1][3]);
            }
          }
        }
      }
    }

    // each valid row's partial
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = h2 ? r1 : r0;
      if (r >= nG) continue;
      const size_t part =
          ((static_cast<size_t>(t0 + r / G) * K + kh) * n_span + s) * G +
          r % G;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j) {
        const int d = j * 8 + 2 * (lane & 3);
        if (d < D)
          *reinterpret_cast<float2*>(P.acc + part * D + d) =
              make_float2(acc[j][2 * h2], acc[j][2 * h2 + 1]);
      }
      if ((lane & 3) == 0) {
        P.m[part] = h2 ? m1 : m0;
        P.l[part] = h2 ? l1 : l0;
      }
    }
  }
}

// The route a call takes, by dtypes and head shape alone (never by the
// packing): 0 = the tensor-core kernel (bf16 q over a bf16, int8 or fp8
// pool, D a multiple of 8 up to 256, G <= ROWS), 1 = the span kernel,
// 2 = the staged wide kernel.
inline int route(bool q_bf16, bool pool_f32, int D, int G, int ve) {
  if (q_bf16 && !pool_f32 && D % 8 == 0 && D <= 256 && G <= ROWS) return 0;
  return D > MAX_D || D % ve ? 2 : 1;
}

}  // namespace tc

// Merges the spans of (token t, kv-head kh); l == 0 (pad lanes, nothing
// visible) divides by 1: exact zeros.
template <typename QT>
__global__ void __launch_bounds__(THREADS) ragged_combine_kernel(
    const float* ws, QT* __restrict__ out, int T, int K, int G, int D,
    int n_span) {
  const int t = blockIdx.x, kh = blockIdx.y;
  const size_t parts = static_cast<size_t>(T) * K * n_span * G;
  const Partials P = partials_at(const_cast<float*>(ws), parts, D);
  const size_t q_off = (static_cast<size_t>(t) * K + kh) * G * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    const size_t part0 = (static_cast<size_t>(t) * K + kh) * n_span * G + g;
    float l;
    const float a = combine(P, part0, n_span, G, D, d, l);
    out[q_off + e] = from_f32<QT>(a / (l == 0.f ? 1.f : l));
  }
}

// Launches the span kernel of K/V type KVT; returns cudaGetLastError().
template <typename KVT, bool QUANT>
int launch_spans(const void* q, bool q_bf16, const void* k_pool,
                 const void* v_pool, const void* k_scale, const void* v_scale,
                 const void* block_tables, const void* row_ids,
                 const void* token_pos, float* ws, int T, int K, int G, int D,
                 int R, int nb, int bs, int span, int n_span, float scale,
                 float softcap, int window, cudaStream_t stream) {
  const dim3 grid(T, K, n_span);
  const KVT* kp = static_cast<const KVT*>(k_pool);
  const KVT* vp = static_cast<const KVT*>(v_pool);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* rows = static_cast<const int*>(row_ids);
  const int* pos = static_cast<const int*>(token_pos);
  if (D > MAX_D || D % Word<KVT>::VE) {
    auto kern = ragged_wide_kernel<KVT, QUANT>;
    const size_t smem = wide_smem(G, D, bs);
    const int e = allow_smem(kern, smem);
    if (e) return e;
    kern<<<grid, THREADS, smem, stream>>>(q, q_bf16, kp, vp, ks, vs, bt, rows,
                                          pos, ws, T, R, nb, bs, K, G, D, span,
                                          n_span, scale, softcap, window);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned16 = reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  const Layout L = choose_layout(D, sizeof(KVT), Word<KVT>::VE, aligned16, G);
  const size_t smem = smem_bytes(L, D);
  return with_layout<KVT>(L, [&](auto vb, auto vpl, auto gc) {
    auto kern = ragged_span_kernel<KVT, QUANT, decltype(vb)::value,
                                   decltype(vpl)::value, decltype(gc)::value>;
    const int e = allow_smem(kern, smem);
    if (e) return e;
    kern<<<grid, THREADS, smem, stream>>>(q, q_bf16, kp, vp, ks, vs, bt, rows,
                                          pos, ws, T, R, nb, bs, K, G, D, span,
                                          n_span, L.lr, scale, softcap, window);
    return static_cast<int>(cudaGetLastError());
  });
}

// Launches the tensor-core path: zero the plan's two counters, plan the
// segments (and write the pad lanes' empty partials), then as many CTAs of
// ragged_tc_kernel as stay resident on the card at once, which claim the
// (segment, span, kv-head) items; returns cudaGetLastError().
template <typename KVT, bool QUANT, int DMAX>
int launch_tc(const void* q, const void* k_pool, const void* v_pool,
              const void* k_scale, const void* v_scale,
              const void* block_tables, const void* row_ids,
              const void* token_pos, float* ws, int* plan, int T, int H,
              int K, int G, int D, int R, int nb, int bs, int span,
              int n_span, float scale, float softcap, int window,
              cudaStream_t stream) {
  auto kern = tc::ragged_tc_kernel<KVT, QUANT, DMAX>;
  const size_t smem =
      tc::smem_layout(D, tc::key_tile(DMAX), span, bs, QUANT).total;
  int e = allow_smem(kern, smem);
  if (e) return e;
  int resident = 0;
  if ((e = launch_once::resident_ctas(reinterpret_cast<const void*>(kern),
                                      tc::THREADS, smem, &resident)))
    return e;
  if ((e = cudaMemsetAsync(plan, 0, 2 * sizeof(int), stream))) return e;
  const int* rows = static_cast<const int*>(row_ids);
  const int* pos = static_cast<const int*>(token_pos);
  const size_t parts = static_cast<size_t>(T) * K * n_span * G;
  tc::ragged_tc_plan_kernel<<<static_cast<unsigned>((parts + 255) / 256), 256,
                              0, stream>>>(rows, pos, plan, ws, T, K, G, D,
                                           n_span, tc::ROWS / G);
  if ((e = cudaGetLastError())) return e;
  const long long items = static_cast<long long>(T) * K * n_span;
  const int grid = static_cast<int>(std::min<long long>(items, resident));
  kern<<<grid, tc::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables), rows, pos, plan, ws, T, H, R, nb,
      bs, K, G, D, span, n_span, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KVT, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* block_tables,
           const void* row_ids, const void* token_pos, void* ws, int* plan,
           void* out, int T, int H, int K, int D, int R, int nb, int bs,
           int span, float scale, float softcap, int window,
           cudaStream_t stream) {
  const int G = H / K;
  const int n_span = (nb + span - 1) / span;
  int err;
  constexpr bool tc_types =
      std::is_same<QT, __nv_bfloat16>::value && !std::is_same<KVT, float>::value;
  if (tc::route(std::is_same<QT, __nv_bfloat16>::value,
                std::is_same<KVT, float>::value, D, G, Word<KVT>::VE) == 0) {
    if constexpr (tc_types) {
      float* w = static_cast<float*>(ws);
      err = D <= 128
                ? launch_tc<KVT, QUANT, 128>(
                      q, k_pool, v_pool, k_scale, v_scale, block_tables,
                      row_ids, token_pos, w, plan, T, H, K, G, D, R, nb, bs,
                      span, n_span, scale, softcap, window, stream)
                : launch_tc<KVT, QUANT, 256>(
                      q, k_pool, v_pool, k_scale, v_scale, block_tables,
                      row_ids, token_pos, w, plan, T, H, K, G, D, R, nb, bs,
                      span, n_span, scale, softcap, window, stream);
    } else {
      err = static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    err = launch_spans<KVT, QUANT>(
        q, std::is_same<QT, __nv_bfloat16>::value, k_pool, v_pool, k_scale,
        v_scale, block_tables, row_ids, token_pos, static_cast<float*>(ws), T,
        K, G, D, R, nb, bs, span, n_span, scale, softcap, window, stream);
  }
  if (err) return err;
  ragged_combine_kernel<QT><<<dim3(T, K), THREADS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<QT*>(out), T, K, G, D,
      n_span);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* k_pool,
                const void* v_pool, const void* k_scale, const void* v_scale,
                const void* block_tables, const void* row_ids,
                const void* token_pos, void* ws, int* plan, void* out, int T,
                int H, int K, int D, int R, int nb, int bs, int span,
                float scale, float softcap, int window, cudaStream_t stream) {
#define RPA_ARGS q, k_pool, v_pool, k_scale, v_scale, block_tables, row_ids, \
    token_pos, ws, plan, out, T, H, K, D, R, nb, bs, span, scale, softcap,   \
    window, stream
  switch (kv_dtype) {
    case 0: return launch<QT, float, false>(RPA_ARGS);
    case 1: return launch<QT, __nv_bfloat16, false>(RPA_ARGS);
    case 2: return launch<QT, int8_t, true>(RPA_ARGS);
    case 3: return launch<QT, __nv_fp8_e4m3, true>(RPA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPA_ARGS
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q (T,H,D) and out (T,H,D) in it).
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8, 3 = float8_e4m3fn (2 and 3
// read k_scale / v_scale).  ws: float32 workspace of
// T * K * ceil(nb / span) * (H / K) * (D + 2) elements; plan: int32 buffer
// of 2 + 2 * T elements (the tensor-core path's segments; q, the pools and
// the tables 16-byte aligned there).  H a multiple of K; D >= 1 (the route
// below says which kernel takes which shapes; rows past 256 elements, or not
// whole 32-bit words, take the staged path, bounded by shared memory);
// span >= 1 table blocks.  softcap <= 0 and window <= 0 mean "none".
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ragged_paged_attention(
    int q_dtype, int kv_dtype, const void* q, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* row_ids, const void* token_pos,
    void* ws, void* plan, void* out, int T, int H, int K, int D, int R,
    int nb, int bs, int span, float scale, float softcap, int window,
    void* stream) {
  if (T == 0) return 0;
  if (K < 1 || H % K || D < 1 || nb < 1 || bs < 1 || span < 1 ||
      (nb + span - 1) / span > 65535 || K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* p = static_cast<int*>(plan);
#define RPA_ARGS kv_dtype, q, k_pool, v_pool, k_scale, v_scale, block_tables, \
    row_ids, token_pos, ws, p, out, T, H, K, D, R, nb, bs, span, scale,       \
    softcap, window, s
  switch (q_dtype) {
    case 0: return dispatch_kv<float>(RPA_ARGS);
    case 1: return dispatch_kv<__nv_bfloat16>(RPA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPA_ARGS
}

// Which kernel ragged_paged_attention launches for these dtypes (codes as
// above) and head shape: 0 = the tensor-core kernel, 1 = the span kernel,
// 2 = the staged wide kernel; -1 for codes it does not take.
extern "C" int ragged_paged_attention_route(int q_dtype, int kv_dtype, int H,
                                            int K, int D) {
  static const int ve[] = {1, 2, 4, 4};
  if (q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 3 || K < 1 ||
      H % K)
    return -1;
  return tc::route(q_dtype == 1, kv_dtype == 0, D, H / K, ve[kv_dtype]);
}
