// One-token decode attention over dense per-slot caches, for Hopper (sm_90a),
// CUDA C++ with a plain C entry point loaded through ctypes.
//
// Replaces the TPU kernel kernels/decode_attention/kernel.py
// decode_attention_fwd (body _kernel) of the JAX package.  Row b's new token
// (q (B,H,D), at position q_pos[b]) attends over the S slots of its cache
// (k/v (B,S,K,D)); slot s holds position cache_pos[b, s] (-1 = empty), and a
// slot is visible iff 0 <= kpos <= q_pos (and q_pos - kpos < window), so one
// kernel serves full caches, ring buffers (slot order is not position order)
// and partly filled rows.  GQA: query head h reads kv head h / (H/K), for
// any H/K.  Scores scale, then tanh softcap; online softmax with m, l and
// the accumulator in f32; int8 / fp8-e4m3 caches are dequantized in
// registers with per-(b, slot, kv-head) f32 scales.  q is read in its own
// dtype (f32 or bf16) and the output written in it, rounded once.  A row
// with no visible slot gets the plain version's answer, the uniform average
// of its S values (softmax over scores that are all NEG_INF); the served
// path never makes one, since each step writes its own token before it
// attends.
//
// What bounds it: bytes (each visible slot's K and V rows once).
//
// Design: split_kv.cuh.  Grid (K, B, n_span) over spans of `span` slots
// (cut by slot index, never by position: a ring does not keep them in
// order); each CTA writes its span's partial to the workspace, and a second
// kernel merges the spans of each (row, query head) in span order.
#include "split_kv.cuh"

namespace {

using namespace split_kv;

// Keys are slots of row b: row index (b * S + slot) * K + kh.
struct DenseSource {
  const int* cp;           // cache_pos of row b
  size_t row0;             // b * S * K + kh
  int K, qp, window;
  __device__ size_t row(int slot) const {
    return row0 + static_cast<size_t>(slot) * K;
  }
  __device__ bool visible(int slot) const {
    const int kp = __ldg(cp + slot);
    return kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
  }
};

template <typename KVT, bool QUANT, int VB, int VPL, int GC>
__global__ void __launch_bounds__(THREADS, (min_blocks<KVT, VB, VPL, GC>()))
    decode_span_kernel(
    const void* q, bool q_bf16, const KVT* __restrict__ k_cache,
    const KVT* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ q_pos,
    const int* __restrict__ cache_pos, float* ws, int B, int S, int H, int K,
    int D, int span, int n_span, int lr, float scale, float softcap,
    int window) {
  const int kh = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int G = H / K;
  const size_t parts = static_cast<size_t>(B) * K * n_span * G;
  const Partials P = partials_at(ws, parts, D);
  const size_t part0 = ((static_cast<size_t>(b) * K + kh) * n_span + s) * G;
  const DenseSource src{cache_pos + static_cast<size_t>(b) * S,
                        static_cast<size_t>(b) * S * K + kh, K, q_pos[b],
                        window};
  // a span with no visible slot (past a partial fill, or outside the
  // window) writes the empty partial without loading a row
  const int key0 = s * span, key1 = min(S, (s + 1) * span);
  bool any = false;
  for (int slot = key0 + static_cast<int>(threadIdx.x); slot < key1;
       slot += THREADS)
    any |= src.visible(slot);
  if (!__syncthreads_or(any)) {
    write_empty(P, part0, G);
    return;
  }
  span_partial<KVT, QUANT, VB, VPL, GC>(
      src, key0, key1, q, q_bf16,
      (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * D, k_cache,
      v_cache, k_scale, v_scale, P, part0, G, D, lr, scale, softcap);
}

// Merges the spans of (row b, kv-head kh) for its G query heads.
template <typename QT, typename KVT, bool QUANT>
__global__ void __launch_bounds__(THREADS) decode_combine_kernel(
    const float* ws, const KVT* __restrict__ v_cache,
    const float* __restrict__ v_scale, QT* __restrict__ out, int B, int S,
    int H, int K, int D, int n_span) {
  using W = Word<KVT>;
  constexpr int VE = W::VE;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / K;
  const size_t parts = static_cast<size_t>(B) * K * n_span * G;
  const Partials P = partials_at(const_cast<float*>(ws), parts, D);
  const size_t row0 = static_cast<size_t>(b) * S * K + kh;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    const size_t part0 =
        (static_cast<size_t>(b) * K + kh) * n_span * G + g;
    float l;
    float a = combine(P, part0, n_span, G, D, d, l);
    if (l == 0.f) {
      // nothing visible: the uniform softmax of all-NEG_INF scores
      a = 0.f;
      for (int s = 0; s < S; ++s) {
        const size_t si = row0 + static_cast<size_t>(s) * K;
        const uint32_t word = reinterpret_cast<const uint32_t*>(
            v_cache + si * D)[d / VE];
        a += W::get(word, d % VE) * (QUANT ? v_scale[si] : 1.f);
      }
      l = static_cast<float>(S);
    }
    out[(static_cast<size_t>(b) * H + kh * G + g) * D + d] =
        from_f32<QT>(a / l);
  }
}

template <typename QT, typename KVT, bool QUANT>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, const void* q_pos,
           const void* cache_pos, void* ws, void* out, int B, int S, int H,
           int K, int D, int span, float scale, float softcap, int window,
           cudaStream_t stream) {
  constexpr int VE = Word<KVT>::VE;
  if (D % VE) return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  const int n_span = (S + span - 1) / span;
  const bool aligned16 =
      reinterpret_cast<uintptr_t>(k_cache) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v_cache) % 16 == 0;
  const Layout L = choose_layout(D, sizeof(KVT), VE, aligned16, G);
  const size_t smem = smem_bytes(L, D);
  const int err = with_layout<KVT>(L, [&](auto vb, auto vpl, auto gc) {
    auto kern = decode_span_kernel<KVT, QUANT, decltype(vb)::value,
                                   decltype(vpl)::value, decltype(gc)::value>;
    const int e = allow_smem(kern, smem);
    if (e) return e;
    kern<<<dim3(K, B, n_span), THREADS, smem, stream>>>(
        q, std::is_same<QT, __nv_bfloat16>::value,
        static_cast<const KVT*>(k_cache), static_cast<const KVT*>(v_cache),
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
        static_cast<const int*>(q_pos), static_cast<const int*>(cache_pos),
        static_cast<float*>(ws), B, S, H, K, D, span, n_span, L.lr, scale,
        softcap, window);
    return static_cast<int>(cudaGetLastError());
  });
  if (err) return err;
  decode_combine_kernel<QT, KVT, QUANT><<<dim3(K, B), THREADS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const KVT*>(v_cache),
      static_cast<const float*>(v_scale), static_cast<QT*>(out), B, S, H, K, D,
      n_span);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* k_cache,
                const void* v_cache, const void* k_scale, const void* v_scale,
                const void* q_pos, const void* cache_pos, void* ws, void* out,
                int B, int S, int H, int K, int D, int span, float scale,
                float softcap, int window, cudaStream_t stream) {
#define DA_ARGS q, k_cache, v_cache, k_scale, v_scale, q_pos, cache_pos, ws, \
    out, B, S, H, K, D, span, scale, softcap, window, stream
  switch (kv_dtype) {
    case 0: return launch<QT, float, false>(DA_ARGS);
    case 1: return launch<QT, __nv_bfloat16, false>(DA_ARGS);
    case 2: return launch<QT, int8_t, true>(DA_ARGS);
    case 3: return launch<QT, __nv_fp8_e4m3, true>(DA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_ARGS
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q (B,H,D) and out (B,H,D) in it).
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8, 3 = float8_e4m3fn (2 and 3
// read k_scale / v_scale, (B,S,K) float32).  k/v (B,S,K,D); q_pos (B,) and
// cache_pos (B,S) int32; all contiguous.  ws: float32 workspace of
// B * K * ceil(S / span) * (H / K) * (D + 2) elements.  H a multiple of K;
// 1 <= D <= 256, a multiple of 2 for bfloat16 and of 4 for int8 / fp8
// caches; S >= 1; span >= 1.  softcap <= 0 and window <= 0 mean "none".
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int decode_attention(int q_dtype, int kv_dtype, const void* q,
                                const void* k_cache, const void* v_cache,
                                const void* k_scale, const void* v_scale,
                                const void* q_pos, const void* cache_pos,
                                void* ws, void* out, int B, int S, int H,
                                int K, int D, int span, float scale,
                                float softcap, int window, void* stream) {
  if (K < 1 || H % K || D < 1 || D > MAX_D || S < 1 || span < 1 ||
      (S + span - 1) / span > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DA_ARGS kv_dtype, q, k_cache, v_cache, k_scale, v_scale, q_pos, \
    cache_pos, ws, out, B, S, H, K, D, span, scale, softcap, window, s
  switch (q_dtype) {
    case 0: return dispatch_kv<float>(DA_ARGS);
    case 1: return dispatch_kv<__nv_bfloat16>(DA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_ARGS
}
