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
// Design (simple and correct first):
// - one CTA of 128 threads per (packed token, kv-head); the CTA reads its own
//   row id, position and the row's live-block count (no scalar prefetch);
// - it loops over the row's blocks and stages each (bs, D) K and V tile in
//   shared memory as f32, applying the scales gathered with the same block;
// - all G query heads of the kv-head are handled together; m, l and acc are
//   f32 in shared memory;
// - blocks wholly past the token's position or wholly before its window are
//   skipped: for them p = 0 and alpha = exp(0) = 1, so m, l and acc are
//   unchanged bit for bit, and the live-block early-out
//   (nblk = sum(block_tables >= 0)) keeps the output bit-invariant when a
//   table is widened with -1 columns.
// The per-token CTA streams a row's blocks once per chunk TOKEN, not once per
// row (L2 absorbs part of it).  Tiling chunk tokens x G as the M dimension of
// an mma, splitting long decode rows' KV across CTAs with a combine pass,
// wgmma and TMA are work for later changes.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA cast
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool visible(int kpos, int qp, int window) {
  return kpos <= qp && (window <= 0 || (qp - kpos) < window);
}

template <typename QT, typename KVT, bool QUANT>
__global__ void __launch_bounds__(THREADS) ragged_paged_attention_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ row_ids, const int* __restrict__ token_pos,
    QT* __restrict__ out, int R, int nb, int bs, int K, int G, int D,
    float scale, float softcap, int window) {
  extern __shared__ float smem[];
  __shared__ int s_live;
  const int t = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int GD = G * D, BD = bs * D;
  float* sQ = smem;          // (G, D) query heads of this kv-head
  float* sAcc = sQ + GD;     // (G, D) unnormalised output
  float* sK = sAcc + GD;     // (bs, D) dequantized K tile
  float* sV = sK + BD;       // (bs, D) dequantized V tile
  float* sP = sV + BD;       // (G, bs) masked scores, then probabilities
  float* sM = sP + G * bs;   // (G,) running max
  float* sL = sM + G;        // (G,) running denominator
  float* sA = sL + G;        // (G,) this block's rescale factor

  // A pad row clamps to row 0; token_pos = -1 then masks every position.
  const int row = min(max(row_ids[t], 0), R - 1);
  const int qp = token_pos[t];
  const int* bt = block_tables + static_cast<size_t>(row) * nb;

  if (tid == 0) s_live = 0;
  __syncthreads();
  int cnt = 0;
  for (int j = tid; j < nb; j += THREADS) cnt += bt[j] >= 0;
  for (int o = 16; o; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (lane == 0 && cnt) atomicAdd(&s_live, cnt);

  const size_t q_off = (static_cast<size_t>(t) * K * G + static_cast<size_t>(h) * G) * D;
  for (int e = tid; e < GD; e += THREADS) {
    sQ[e] = to_f32(q[q_off + e]);
    sAcc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }
  __syncthreads();
  const int live = s_live;

  int j_lo = 0, j_hi = 0;
  if (qp >= 0) {
    j_hi = min(live, qp / bs + 1);
    const int first = qp - window + 1;
    if (window > 0 && first > 0) j_lo = first / bs;
  }

  for (int j = j_lo; j < j_hi; ++j) {
    // -1 entries below the live count clamp to block 0 (the null block).
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
        float s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        sP[pr] = visible(j * bs + p, qp, window) ? s : NEG_INF;
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
        // Explicit re-mask: when every position of the block is masked,
        // s - m_new is NEG_INF - NEG_INF = 0 and exp would emit ones.
        const float pv = visible(j * bs + p, qp, window)
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

  // l == 0 (pad lanes, nothing visible) divides by 1: exact zeros.
  for (int e = tid; e < GD; e += THREADS) {
    float l = sL[e / D];
    if (l == 0.f) l = 1.f;
    out[q_off + e] = from_f32<QT>(sAcc[e] / l);
  }
}

template <typename QT, typename KVT, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* block_tables,
           const void* row_ids, const void* token_pos, void* out, int T, int H,
           int K, int D, int R, int nb, int bs, float scale, float softcap,
           int window, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = (2 * static_cast<size_t>(G) * D + 2 * static_cast<size_t>(bs) * D +
                       static_cast<size_t>(G) * bs + 3 * static_cast<size_t>(G)) * sizeof(float);
  auto kern = ragged_paged_attention_kernel<QT, KVT, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(T, K), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(block_tables),
      static_cast<const int*>(row_ids), static_cast<const int*>(token_pos),
      static_cast<QT*>(out), R, nb, bs, K, G, D, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* k_pool, const void* v_pool,
                const void* k_scale, const void* v_scale, const void* block_tables,
                const void* row_ids, const void* token_pos, void* out, int T, int H,
                int K, int D, int R, int nb, int bs, float scale, float softcap,
                int window, cudaStream_t stream) {
#define RPA_ARGS q, k_pool, v_pool, k_scale, v_scale, block_tables, row_ids, \
    token_pos, out, T, H, K, D, R, nb, bs, scale, softcap, window, stream
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

// q_dtype: 0 = float32, 1 = bfloat16.
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8, 3 = float8_e4m3fn (2 and 3
// read k_scale / v_scale).  softcap <= 0 and window <= 0 mean "none".
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ragged_paged_attention(
    int q_dtype, int kv_dtype, const void* q, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* row_ids, const void* token_pos,
    void* out, int T, int H, int K, int D, int R, int nb, int bs, float scale,
    float softcap, int window, void* stream) {
  if (T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return dispatch_kv<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                                block_tables, row_ids, token_pos, out, T, H, K, D,
                                R, nb, bs, scale, softcap, window, s);
    case 1:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, k_scale,
                                        v_scale, block_tables, row_ids, token_pos,
                                        out, T, H, K, D, R, nb, bs, scale, softcap,
                                        window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
