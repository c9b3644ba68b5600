// Flash attention, forward only, for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes.
//
// Replaces the TPU kernel kernels/flash_attention/kernel.py flash_attention_fwd
// (body _kernel) of the JAX package.  q (B,S,H,D) attends causally over k/v
// (B,S,K,D) with GQA (query head h reads kv head h / (H/K)); optional sliding
// window ((qpos - kpos) < window, strict) and tanh softcap applied after the
// scale; keys at or past S are masked; online softmax with m, l, the
// probabilities p and the accumulator in f32 (bf16 inputs are widened on
// load, as the TPU kernel widens them); the output is rounded once to q's
// dtype.  Positions are 0..S-1: like the TPU kernel it takes no positions.
//
// What bounds it: operations.  Every visible (query, key) pair costs two
// D-long products per query head, 4·D·H flops over all heads (16,384 at
// gemma2-9b's H = 16, D = 256), while q, k, v and out, each read or written
// once, come to about 6 bytes per visible pair in bf16 at S = 8192: some
// 2,700 flops per byte, far past the card's ~300 flop/byte balance point.
// So the floor is the tensor cores' rate on the causal band.
//
// Design (simple and correct first; the tensor cores are work for later):
// - one CTA of 256 threads per (q-block of 64 rows, query head, batch row);
//   the TPU's sequential kv grid axis becomes a loop inside the CTA over the
//   64-key blocks that meet the causal band and the window; whole blocks
//   outside are skipped, which is exact (p = 0 and alpha = 1 there);
// - the q tile stays in shared memory as f32 (row stride D+1, so the two
//   rows a warp reads sit in different banks); each K tile is stored
//   transposed (stride 65) so a warp reads 16 consecutive keys, then the V
//   tile reuses the same buffer; with D up to 256 the CTA takes up to
//   149 KB of dynamic shared memory (opted in above 48 KB); tiles load with
//   16 scalar loads in flight per thread (element loads with no vector
//   width, so any D and any row stride will do);
// - a 16 x 16 thread grid: each thread owns 4 query rows (ty + 16 i) x 4 keys
//   (tx + 16 j) of the score tile and the same 4 rows x ceil(D/16) output
//   columns (tx + 16 j, guarded by c < D, so D = 80, 120 or 160 needs no
//   vector width) of the f32 accumulator, kept in registers; the row max and sum
//   reduce over the 16 lanes of a half-warp with shuffles;
// - p is re-masked explicitly (p = 0 off the band): a row whose first
//   computed block is wholly masked keeps l = 0 and acc = 0 there, where the
//   TPU kernel adds exp(0) = 1 terms and wipes them with alpha = 0 at the
//   row's first visible key; the result is the same;
// - q-blocks launch heaviest first (the last rows see the most keys), so
//   the causal imbalance does not leave a tail of long CTAs.
// f32 FMAs fed from shared memory run far under the tensor cores' rate:
// mma/wgmma on bf16 tiles staged by TMA, with p rounded once for the P·V
// product, is the next change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;              // query rows per CTA
constexpr int BK = 64;              // keys per block of the inner loop
constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RI = BQ / TY;         // query rows per thread
constexpr int CJ = BK / TX;         // keys per thread in the score tile
constexpr int BKP = BK + 1;         // padded stride of K^T and P

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA cast
}

// max / sum over the 16 lanes that share a query row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
  for (int o = TX / 2; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int o = TX / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(int kp, int qp, int S, int window) {
  return kp <= qp && kp < S && (window <= 0 || (qp - kp) < window);
}

// Copies rows s0 .. s0+rows-1 (zeros at or past S) of a (.., D) slice whose
// positions are row_stride elements apart into shared memory as f32: row r,
// column d at dst[r * dst_stride + d], or at dst[d * dst_stride + r] when
// TRANSPOSE.  Each thread keeps LU loads in flight before it stores, so a
// tile costs a few memory latencies instead of one per element.
template <bool TRANSPOSE, typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int dst_stride,
                                          const T* __restrict__ src,
                                          size_t row_stride, int s0, int rows,
                                          int S, int D, int tid) {
  constexpr int LU = 16;
  const int n = rows * D;
  for (int e0 = tid; e0 < n; e0 += THREADS * LU) {
    float x[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int e = e0 + u * THREADS;
      const int r = e / D, d = e - r * D;
      x[u] = (e < n && s0 + r < S) ? to_f32(src[(s0 + r) * row_stride + d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int e = e0 + u * THREADS;
      const int r = e / D, d = e - r * D;
      if (e < n) dst[TRANSPOSE ? d * dst_stride + r : r * dst_stride + d] = x[u];
    }
  }
}

size_t smem_bytes(int D) {
  return (static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(D) * BKP +
          static_cast<size_t>(BQ) * BKP) * sizeof(float);
}

// NJ = output columns per thread: 16 * NJ >= D.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int H, int K, int D, float scale, float softcap,
    int window) {
  extern __shared__ float smem[];
  const int DQ = D + 1;
  float* sQ = smem;             // (BQ, D+1) query tile
  float* sKV = sQ + BQ * DQ;    // K^T (D, BKP), then V (BK, D)
  float* sP = sKV + D * BKP;    // (BQ, BKP) probabilities

  const int iq = gridDim.x - 1 - blockIdx.x;   // heaviest q-blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid - ty * TX;
  const int q0 = iq * BQ;
  const size_t q_row = static_cast<size_t>(H) * D;   // stride between positions
  const size_t kv_row = static_cast<size_t>(K) * D;
  const T* qb = q + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kh) * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kh) * D;
  T* ob = out + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * D;

  load_tile<false>(sQ, DQ, qb, q_row, q0, BQ, S, D, tid);

  float acc[RI][NJ];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the k-blocks that meet the band of this q-block: causal (a block's first
  // key <= the newest query) and window (its last key >= the oldest query's
  // first visible key)
  const int nk = (S + BK - 1) / BK;
  const int k_hi = min(nk - 1, (q0 + BQ - 1) / BK);
  int k_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) k_lo = (q0 - window + 1) / BK;

  for (int ik = k_lo; ik <= k_hi; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();            // the last block's readers of sKV / sP are done
    load_tile<true>(sKV, BKP, kb, kv_row, k0, BK, S, D, tid);
    __syncthreads();

    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RI], ka[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qa[i] = sQ[(ty + TY * i) * DQ + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) ka[j] = sKV[d * BKP + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }

    float alpha[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s = visible(k0 + tx + TX * j, qp, S, window) ? s : NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = visible(k0 + tx + TX * j, qp, S, window)
                            ? expf(sc[i][j] - m_new) : 0.f;
        sP[(ty + TY * i) * BKP + tx + TX * j] = p;
        sum += p;
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + row_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();            // P written, K^T no longer read

    load_tile<false>(sKV, D, vb, kv_row, k0, BK, S, D, tid);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int p = 0; p < BK; ++p) {
      float pa[RI], va[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pa[i] = sP[(ty + TY * i) * BKP + p];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + TX * j;
        va[j] = c < D ? sKV[p * D + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }

  // l == 0 (nothing visible) divides by 1, as the TPU kernel does
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s = q0 + ty + TY * i;
    if (s >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + TX * j;
      if (c < D) ob[s * q_row + c] = from_f32<T>(acc[i][j] / li);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int H, int K, int D, float scale, float softcap, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kern = flash_attention_kernel<T, NJ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, K, D, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_width(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int H, int K, int D, float scale, float softcap,
                   int window, cudaStream_t stream) {
#define FA_ARGS q, k, v, out, B, S, H, K, D, scale, softcap, window, stream
  const int need = (D + TX - 1) / TX;
  if (need <= 1) return launch<T, 1>(FA_ARGS);
  if (need <= 2) return launch<T, 2>(FA_ARGS);
  if (need <= 4) return launch<T, 4>(FA_ARGS);
  if (need <= 5) return launch<T, 5>(FA_ARGS);
  if (need <= 8) return launch<T, 8>(FA_ARGS);
  if (need <= 10) return launch<T, 10>(FA_ARGS);   // D = 160 (zamba2-2.7b)
  if (need <= 16) return launch<T, 16>(FA_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
#undef FA_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  q and out are
// (B,S,H,D), k and v (B,S,K,D), all contiguous; H % K == 0; 1 <= D <= 256.
// softcap <= 0 and window <= 0 mean "none".  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int S, int H,
                               int K, int D, float scale, float softcap,
                               int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_width<float>(q, k, v, out, B, S, H, K, D, scale, softcap,
                                   window, s);
    case 1:
      return dispatch_width<__nv_bfloat16>(q, k, v, out, B, S, H, K, D, scale,
                                           softcap, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
