// One-token decode attention over dense per-slot caches, for Hopper (sm_90a),
// CUDA C++ with a plain C entry point loaded through ctypes.
//
// Replaces the TPU kernel kernels/decode_attention/kernel.py
// decode_attention_fwd (body _kernel) of the JAX package.  Row b's new token
// (q (B,H,D), at position q_pos[b]) attends over the S slots of its cache
// (k/v (B,S,K,D)); slot s holds position cache_pos[b, s] (-1 = empty), and a
// slot is visible iff 0 <= kpos <= q_pos (and q_pos - kpos < window), so one
// kernel serves full caches, ring buffers (slot order is not position order)
// and partly filled rows.  GQA: query head h reads kv head h / (H/K).  Scores
// scale, then tanh softcap; online softmax with m, l and the accumulator in
// f32; int8 / fp8-e4m3 caches are dequantized in registers with per-(b, slot,
// kv-head) f32 scales.  q is read as f32 and the output written as f32 (the
// wrapper widens q and rounds the output to q's dtype once).  A row with no
// visible slot gets the plain version's answer, the uniform average of its
// S values (softmax over scores that are all NEG_INF); the served path never
// makes one, since each step writes its own token before it attends.
//
// What bounds it: bytes.  Each visible K/V element feeds 2 flops per query
// head of its kv-head (G = 1 for zamba2-2.7b, 2 for gemma2-9b), far under
// the card's ~300 flop/byte balance point: the floor is streaming every
// visible slot's K and V rows once.
//
// Design (simple and correct first):
// - one CTA of 8 warps per (batch row, kv-head); the TPU's sequential block
//   axis becomes a loop in which warp w takes query head w % G and every
//   (8/G)-th group of 4 slots, so the G heads share each row while it is in
//   L1, and each warp keeps its own m, l and accumulator in registers (lane
//   holds columns lane + 32 i, so any D <= 256 works);
// - a warp reads a group's positions first and skips the group when no slot
//   is visible (ring caches: the positions are the only way to know), and
//   issues all of a group's K and V loads, one 32-bit word (1 f32, 2 bf16,
//   4 int8 / fp8 values) per instruction, before it uses any;
// - at the end the warps of a head merge their (m, l, acc) in shared memory.
// Splitting long rows across more CTAs (only B x K CTAs run: 64 for gemma2's
// kernel case), vector loads and TMA are work for later changes.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int U = 4;                 // slots a warp loads before it computes
constexpr int MAX_D = 256;

// A cache row is read as 32-bit words: VE elements of type T in each, lane
// l holding elements (l + 32 i) * VE + e.  One load instruction per word
// (instead of one per element) keeps a bf16 or 8-bit row's loads as few, and
// as many in flight, as an f32 row's.
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DI = 32-bit words per lane per row: 32 * DI * VE >= D.
template <typename KVT, bool QUANT, int DI>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const float* __restrict__ q, const KVT* __restrict__ k_cache,
    const KVT* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ q_pos,
    const int* __restrict__ cache_pos, float* __restrict__ out, int S, int H,
    int K, int D, float scale, float softcap, int window) {
  using W = Word<KVT>;
  constexpr int VE = W::VE;
  __shared__ float sM[WARPS], sL[WARPS];
  __shared__ float sAcc[WARPS][MAX_D];
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int G = H / K;
  const int g = w % G, part = w / G, nparts = WARPS / G;
  const int qp = q_pos[b];
  const int* cp = cache_pos + static_cast<size_t>(b) * S;
  // slot s, this kv head: element (b, s, kh, d) at (row0 + s * K) * D + d
  const size_t row0 = static_cast<size_t>(b) * S * K + kh;
  const int nw = D / VE;              // words in a row

  float qv[DI][VE], acc[DI][VE];
  const float* qh = q + (static_cast<size_t>(b) * H + kh * G + g) * D;
#pragma unroll
  for (int i = 0; i < DI; ++i)
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int d = (lane + 32 * i) * VE + e;
      qv[i][e] = d < D ? qh[d] : 0.f;
      acc[i][e] = 0.f;
    }
  float m = NEG_INF, l = 0.f;

  for (int base = part * U; base < S; base += nparts * U) {
    bool vis[U];
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = base + u;
      const int kp = s < S ? cp[s] : -1;
      vis[u] = kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
      any |= vis[u];
    }
    if (!any) continue;               // the same on every lane
    uint32_t kw[U][DI], vw[U][DI];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t r = (row0 + static_cast<size_t>(base + u) * K) * D;
      const uint32_t* kr = reinterpret_cast<const uint32_t*>(k_cache + r);
      const uint32_t* vr = reinterpret_cast<const uint32_t*>(v_cache + r);
#pragma unroll
      for (int i = 0; i < DI; ++i) {
        const int j = lane + 32 * i;
        const bool ok = vis[u] && j < nw;
        kw[u][i] = ok ? __ldg(kr + j) : 0u;
        vw[u][i] = ok ? __ldg(vr + j) : 0u;
      }
    }
    float ks[U], vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t si = row0 + static_cast<size_t>(base + u) * K;
      ks[u] = QUANT && vis[u] ? k_scale[si] : 1.f;
      vs[u] = QUANT && vis[u] ? v_scale[si] : 1.f;
    }
    float sc[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DI; ++i)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          dot = fmaf(qv[i][e], W::get(kw[u][i], e) * ks[u], dot);
      float s = warp_sum(dot) * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      sc[u] = s;
      if (vis[u]) mx = fmaxf(mx, s);
    }
    const float alpha = expf(m - mx);   // 0 while m is still NEG_INF
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DI; ++i)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[i][e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!vis[u]) continue;
      const float p = expf(sc[u] - mx);
      l += p;
#pragma unroll
      for (int i = 0; i < DI; ++i)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          acc[i][e] = fmaf(p, W::get(vw[u][i], e) * vs[u], acc[i][e]);
    }
    m = mx;
  }

  if (lane == 0) {
    sM[w] = m;
    sL[w] = l;
  }
#pragma unroll
  for (int i = 0; i < DI; ++i)
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int d = (lane + 32 * i) * VE + e;
      if (d < D) sAcc[w][d] = acc[i][e];
    }
  __syncthreads();

  for (int e = tid; e < G * D; e += THREADS) {
    const int gg = e / D, d = e - gg * D;
    float mm = NEG_INF;
    for (int p = 0; p < nparts; ++p) mm = fmaxf(mm, sM[p * G + gg]);
    float ll = 0.f, aa = 0.f;
    for (int p = 0; p < nparts; ++p) {
      const float c = expf(sM[p * G + gg] - mm);
      ll = fmaf(c, sL[p * G + gg], ll);
      aa = fmaf(c, sAcc[p * G + gg][d], aa);
    }
    if (ll == 0.f) {
      // nothing visible: the uniform softmax of all-NEG_INF scores
      aa = 0.f;
      for (int s = 0; s < S; ++s) {
        const size_t si = row0 + static_cast<size_t>(s) * K;
        const uint32_t word = reinterpret_cast<const uint32_t*>(
            v_cache + si * D)[d / VE];
        aa += W::get(word, d % VE) * (QUANT ? v_scale[si] : 1.f);
      }
      ll = static_cast<float>(S);
    }
    out[(static_cast<size_t>(b) * H + kh * G + gg) * D + d] = aa / ll;
  }
}

template <typename KVT, bool QUANT, int DI>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, const void* q_pos,
           const void* cache_pos, void* out, int B, int S, int H, int K, int D,
           float scale, float softcap, int window, cudaStream_t stream) {
  decode_attention_kernel<KVT, QUANT, DI><<<dim3(K, B), THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const KVT*>(k_cache),
      static_cast<const KVT*>(v_cache), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(q_pos),
      static_cast<const int*>(cache_pos), static_cast<float*>(out), S, H, K, D,
      scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename KVT, bool QUANT>
int dispatch_width(const void* q, const void* k_cache, const void* v_cache,
                   const void* k_scale, const void* v_scale, const void* q_pos,
                   const void* cache_pos, void* out, int B, int S, int H, int K,
                   int D, float scale, float softcap, int window,
                   cudaStream_t stream) {
#define DA_ARGS q, k_cache, v_cache, k_scale, v_scale, q_pos, cache_pos, out, \
    B, S, H, K, D, scale, softcap, window, stream
  constexpr int VE = Word<KVT>::VE;
  if (D % VE) return static_cast<int>(cudaErrorInvalidValue);
  const int need = (D / VE + 31) / 32;
  if (need <= 1) return launch<KVT, QUANT, 1>(DA_ARGS);
  if (need <= 2) return launch<KVT, QUANT, 2>(DA_ARGS);
  if (need <= 3) return launch<KVT, QUANT, 3>(DA_ARGS);
  if (need <= 4) return launch<KVT, QUANT, 4>(DA_ARGS);
  if (need <= 5) return launch<KVT, QUANT, 5>(DA_ARGS);
  if (need <= 8) return launch<KVT, QUANT, 8>(DA_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
#undef DA_ARGS
}

}  // namespace

// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8, 3 = float8_e4m3fn (2 and 3
// read k_scale / v_scale, (B,S,K) float32).  q and out (B,H,D) float32; k/v
// (B,S,K,D); q_pos (B,) and cache_pos (B,S) int32; all contiguous.
// H / K must divide 8; 1 <= D <= 256, a multiple of 2 for bfloat16 and of
// 4 for int8 / fp8 caches; S >= 1.  softcap <= 0 and window <= 0
// mean "none".  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decode_attention(int kv_dtype, const void* q, const void* k_cache,
                                const void* v_cache, const void* k_scale,
                                const void* v_scale, const void* q_pos,
                                const void* cache_pos, void* out, int B, int S,
                                int H, int K, int D, float scale, float softcap,
                                int window, void* stream) {
  if (K < 1 || H % K || WARPS % (H / K) || D < 1 || D > MAX_D || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DA_ARGS q, k_cache, v_cache, k_scale, v_scale, q_pos, cache_pos, out, \
    B, S, H, K, D, scale, softcap, window, s
  switch (kv_dtype) {
    case 0: return dispatch_width<float, false>(DA_ARGS);
    case 1: return dispatch_width<__nv_bfloat16, false>(DA_ARGS);
    case 2: return dispatch_width<int8_t, true>(DA_ARGS);
    case 3: return dispatch_width<__nv_fp8_e4m3, true>(DA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_ARGS
}
