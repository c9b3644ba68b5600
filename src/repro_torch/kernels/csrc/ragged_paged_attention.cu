// Ragged paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces the TPU kernel kernels/decode_attention/kernel.py
// ragged_paged_attention_fwd (body _ragged_kernel) of the JAX package.  Each
// packed token t attends causally (kpos <= token_pos[t]) over the KV blocks
// of its request row row_ids[t], gathered through block_tables; optional
// sliding window ((qp - kpos) < window) and tanh softcap applied after the
// scale; online softmax in f32; int8 / fp8-e4m3 pools are dequantized in
// registers with per-(block, slot, kv-head) f32 scales.
//
// What bounds it: bytes.  Every visible K/V element is used for 2 flops per
// query head of its kv-head (G = 2 for gemma2), far below the card's
// ~300 flop/byte balance point, so the floor is streaming each request row's
// live blocks once per kv-head from device memory.
//
// Design: split_kv.cuh.  Grid (T, K, n_span) over spans of `span` table
// blocks; a CTA reads its own row id, position and the row's live-block
// count (live = sum(block_tables[row] >= 0), no scalar prefetch) and walks
// the blocks of its span that lie in the token's visible range
// [j_lo, j_hi), j_hi = min(live, qp / bs + 1).  That range depends only on
// the position, the window and `live`, so widening a table with -1 columns
// adds only empty spans (the output stays bit-invariant), and a k = 0
// verify row computes exactly what paged decode computes for it.  Pad lanes
// (row_ids or token_pos < 0) write empty partials and come out of the
// combine as exact zeros.  Each chunk TOKEN still streams its row's blocks
// (L2 absorbs part of it); tiling chunk tokens x G as the M dimension of an
// mma is work for a later change.
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

template <typename QT, typename KVT, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* block_tables,
           const void* row_ids, const void* token_pos, void* ws, void* out,
           int T, int H, int K, int D, int R, int nb, int bs, int span,
           float scale, float softcap, int window, cudaStream_t stream) {
  const int G = H / K;
  const int n_span = (nb + span - 1) / span;
  const int err = launch_spans<KVT, QUANT>(
      q, std::is_same<QT, __nv_bfloat16>::value, k_pool, v_pool, k_scale,
      v_scale, block_tables, row_ids, token_pos, static_cast<float*>(ws), T,
      K, G, D, R, nb, bs, span, n_span, scale, softcap, window, stream);
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
                const void* token_pos, void* ws, void* out, int T, int H,
                int K, int D, int R, int nb, int bs, int span, float scale,
                float softcap, int window, cudaStream_t stream) {
#define RPA_ARGS q, k_pool, v_pool, k_scale, v_scale, block_tables, row_ids, \
    token_pos, ws, out, T, H, K, D, R, nb, bs, span, scale, softcap, window, \
    stream
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
// T * K * ceil(nb / span) * (H / K) * (D + 2) elements.  H a multiple of
// K; D >= 1 (rows past 256 elements, or not whole 32-bit words, take the
// staged path, bounded by shared memory); span >= 1 table blocks.
// softcap <= 0 and window <= 0 mean "none".  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int ragged_paged_attention(
    int q_dtype, int kv_dtype, const void* q, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* row_ids, const void* token_pos,
    void* ws, void* out, int T, int H, int K, int D, int R, int nb, int bs,
    int span, float scale, float softcap, int window, void* stream) {
  if (T == 0) return 0;
  if (K < 1 || H % K || D < 1 || nb < 1 || bs < 1 || span < 1 ||
      (nb + span - 1) / span > 65535 || K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_ARGS kv_dtype, q, k_pool, v_pool, k_scale, v_scale, block_tables, \
    row_ids, token_pos, ws, out, T, H, K, D, R, nb, bs, span, scale, softcap, \
    window, s
  switch (q_dtype) {
    case 0: return dispatch_kv<float>(RPA_ARGS);
    case 1: return dispatch_kv<__nv_bfloat16>(RPA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPA_ARGS
}
