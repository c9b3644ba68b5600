// Flash attention, forward only, for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes.
//
// Replaces the TPU kernel kernels/flash_attention/kernel.py flash_attention_fwd
// (body _kernel) of the JAX package.  q (B,S,H,D) attends causally over k/v
// (B,S,K,D) with GQA (query head h reads kv head h / (H/K)); optional sliding
// window ((qpos - kpos) < window, strict) and tanh softcap applied after the
// scale; keys at or past S are masked; online softmax with m, l, the
// probabilities p and the accumulator in f32; the output is rounded once to
// q's dtype.  Positions are 0..S-1: like the TPU kernel it takes no
// positions.
//
// What bounds it: operations.  Every visible (query, key) pair costs two
// D-long products per query head, 4·D·H flops over all heads (16,384 at
// gemma2-9b's H = 16, D = 256), while q, k, v and out, each read or written
// once, come to about 6 bytes per visible pair in bf16 at S = 8192: some
// 2,700 flops per byte, far past the card's ~300 flop/byte balance point.
// So the floor is the tensor cores' rate on the causal band.
//
// Two kernels, chosen by dtype alone:
//
// bf16: both products on the tensor cores (wgmma, bf16 operands, f32
// accumulators), warp-specialised.
// - One CTA of 3 warpgroups per (q-block of 128 rows, query head, batch
//   row), heaviest q-blocks first (the last rows see the most keys).  Two
//   consumer warpgroups own 64 query rows each; one thread of the third, the
//   producer, issues every TMA load.  setmaxnreg moves registers from the
//   producer (24) to the consumers (240): the O accumulator alone takes
//   PN/2 f32 registers a thread.
// - Shared memory holds q (loaded once), and a ring of 2-4 stages of one
//   64-key K tile and one V tile each (as many as fit in 227 KB: 2 at
//   D = 256, 3 at 160, 4 at 128 and below).  Every tile is a row of
//   64-column boxes in TMA's 128-byte swizzle; the head_dim is padded to DP,
//   a multiple of 64, by TMA's zero fill past D (D = 80, 96, 120, 160 read
//   as 128, 128, 128, 192), so one layout serves every D that is a multiple
//   of 8 (TMA wants 16-byte strides).  P·V is PN = D columns wide for the
//   configs' D = 80, 96, 120 and 160 (wgmma's N steps by 8 across the
//   boxes), DP for any other D; Q·Kᵀ takes ceil(D/16) k-steps.  Full barriers
//   (K and V apart, so Q·Kᵀ starts before V lands) and empty barriers
//   (one arrival per consumer warp) pace the ring.
// - S = Q·Kᵀ: wgmma m64n64k16 from shared memory, K-major A and B,
//   stepping 32 bytes inside a swizzled row and one box per 4 steps.
// - Softmax in registers in the log2 domain (log2(e) folded into the scale,
//   one FFMA per exponent; ex2.approx, relative error ~2^-22).  Masked
//   scores are -inf and the running max starts at -1e30, so p is exactly 0
//   off the band and a row with nothing visible yet keeps l = 0 and
//   acc = 0.  The softcap's tanh is 1 - 2 / (2^(2·log2(e)·y) + 1) from
//   ex2.approx and rcp.approx (1 ulp): tanh.approx's relative error of
//   ~2^-11, times a cap of 50, would move the scores by up to 0.02.
// - O += P·V: P is the A operand from registers (the score accumulator's
//   layout is wgmma's register A layout), V the B operand from shared
//   memory, MN-major (the transpose flag).  P stays at f32 precision: each
//   p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), two wgmma
//   into the same accumulator.  |p - p_hi - p_lo| <= 2^-8 |p - p_hi| <=
//   2^-16 p, so the product errs by at most 2^-16 Σ p|v| / l on an output
//   (the terms' errors have random signs and mostly cancel; the CPU test
//   holds an emulation under 2^-17), far below the bf16 rounding of the
//   result.  One rounding of p, as FA2/FA3
//   do, errs by up to 2^-8 p a term, as much as the bf16 rounding of the
//   output itself, and breaks the check that holds each bf16 output to one
//   rounding of the f32 value.  The split costs 1.5x the tensor-core work
//   of one rounding and no extra accumulator registers.
// - The accumulator is rescaled only when some row of the warp has a new
//   maximum, which late blocks rarely bring.  A warpgroup waits for each
//   product before it goes on, and the two consumer warpgroups run
//   unordered.  Two of FA3's overlaps measured slower on the card in this
//   design: taking turns at issuing the products (ping-pong, with named
//   barriers), and issuing Q·Kᵀ of block i with P·V of block i - 1 to run
//   block i's softmax under P·V(i - 1).
// - Blocks wholly outside a warpgroup's band or window (at most the first
//   or the last of the CTA's) are skipped: the warpgroup waits for them and
//   releases the stage.  The mask is evaluated only on blocks that cross
//   the diagonal, the window's edge or S.
// - The output is divided by l (1 where l = 0), rounded to bf16 into the
//   warpgroup's own q rows of shared memory in the swizzled layout, and
//   written by TMA stores, which clip rows past S and columns past D.
//
// f32: the tensor cores have no f32 mode that meets the f32 tolerance
// (TF32 keeps ~3 digits), so f32 keeps FMAs fed from shared memory:
// - one CTA of 256 threads per (q-block of 64 rows, query head, batch row);
//   the TPU's sequential kv grid axis becomes a loop inside the CTA over the
//   64-key blocks that meet the causal band and the window; whole blocks
//   outside are skipped, which is exact (p = 0 and alpha = 1 there);
// - the q tile stays in shared memory (row stride D+1, so the two rows a
//   warp reads sit in different banks); each K tile is stored transposed
//   (stride 65) so a warp reads 16 consecutive keys, then the V tile reuses
//   the same buffer; up to 149 KB of dynamic shared memory at D = 256;
// - a 16 x 16 thread grid: each thread owns 4 query rows x 4 keys of the
//   score tile and the same 4 rows x ceil(D/16) output columns (guarded by
//   c < D, so any D up to 256 will do) of the accumulator, in registers;
//   the row max and sum reduce over a half-warp with shuffles; p is
//   re-masked explicitly.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"
#include "launch_once.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ======================================================= f32: FMA kernel
namespace simt {

constexpr int BQ = 64;              // query rows per CTA
constexpr int BK = 64;              // keys per block of the inner loop
constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RI = BQ / TY;         // query rows per thread
constexpr int CJ = BK / TX;         // keys per thread in the score tile
constexpr int BKP = BK + 1;         // padded stride of K^T and P

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
// positions are row_stride elements apart into shared memory: row r,
// column d at dst[r * dst_stride + d], or at dst[d * dst_stride + r] when
// TRANSPOSE.  Each thread keeps LU loads in flight before it stores, so a
// tile costs a few memory latencies instead of one per element.
template <bool TRANSPOSE>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int dst_stride,
                                          const float* __restrict__ src,
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
      x[u] = (e < n && s0 + r < S) ? src[(s0 + r) * row_stride + d] : 0.f;
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
template <int NJ>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S, int H,
    int K, int D, float scale, float softcap, int window) {
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
  const float* qb = q + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kh) * D;
  const float* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kh) * D;
  float* ob = out + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * D;

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
      if (c < D) ob[s * q_row + c] = acc[i][j] / li;
    }
  }
}


template <int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int H, int K, int D, float scale, float softcap, int window,
           int smem, cudaStream_t stream) {
  auto kern = flash_attention_kernel<NJ>;
  if (const int e = launch_once::allow_smem(
          reinterpret_cast<const void*>(kern), smem))
    return e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, K, D,
      scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

int run(const void* q, const void* k, const void* v, void* out, int B, int S,
        int H, int K, int D, float scale, float softcap, int window, int smem,
        cudaStream_t stream) {
  if (static_cast<size_t>(smem) < smem_bytes(D))
    return static_cast<int>(cudaErrorInvalidValue);
#define FA_ARGS q, k, v, out, B, S, H, K, D, scale, softcap, window, smem, stream
  const int need = (D + TX - 1) / TX;
  if (need <= 1) return launch<1>(FA_ARGS);
  if (need <= 2) return launch<2>(FA_ARGS);
  if (need <= 4) return launch<4>(FA_ARGS);
  if (need <= 5) return launch<5>(FA_ARGS);
  if (need <= 8) return launch<8>(FA_ARGS);
  if (need <= 10) return launch<10>(FA_ARGS);   // D = 160 (zamba2-2.7b)
  if (need <= 16) return launch<16>(FA_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
#undef FA_ARGS
}

}  // namespace simt

// ================================================= bf16: tensor-core kernel
namespace tc {

constexpr int BQ = 128;                  // query rows per CTA
constexpr int BK = 64;                   // keys per tile
constexpr int THREADS = 384;             // 2 consumer + 1 producer warpgroup
constexpr uint32_t ROW = 128;            // bytes of a swizzled box row
constexpr uint32_t Q_BOX = BQ * ROW;     // one 64-column box of the q tile
constexpr uint32_t KV_BOX = BK * ROW;    // one 64-column box of a K/V tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {   // within 1 ulp
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = 1 - 2 / (e^(2y) + 1), to a few f32 ulps of 1 (see the note)
__device__ __forceinline__ float tanh_ex2(float y) {
  return 1.f - 2.f * rcp(ex2(y * (2.f * LOG2E)) + 1.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// p_hi = bf16(p) of a pair, and what it leaves: the pair p - p_hi, rounded
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

template <int PN>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (PN == 64) hopper::wgmma_rs_n64(o, a, db, 1);
  else if constexpr (PN == 80) hopper::wgmma_rs_n80(o, a, db, 1);
  else if constexpr (PN == 96) hopper::wgmma_rs_n96(o, a, db, 1);
  else if constexpr (PN == 120) hopper::wgmma_rs_n120(o, a, db, 1);
  else if constexpr (PN == 128) hopper::wgmma_rs_n128(o, a, db, 1);
  else if constexpr (PN == 160) hopper::wgmma_rs_n160(o, a, db, 1);
  else if constexpr (PN == 192) hopper::wgmma_rs_n192(o, a, db, 1);
  else hopper::wgmma_rs_n256(o, a, db, 1);
}

// NC = DP / 64 boxes of 64 columns, DP >= D the padded head_dim; PN, the
// output columns computed (D where a wgmma width is D, else DP)
template <int NC, int PN>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, int S, int H, int K,
    int ksteps, int stages, float scale, float softcap, int window) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled boxes want 1024-byte alignment; the plan adds 1 KB for it
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = base;                       // NC boxes of (128 rows, 64 cols)
  uint8_t* sKV = sQ + NC * Q_BOX;           // per stage: NC K boxes, NC V
  uint64_t* full_k =
      reinterpret_cast<uint64_t*>(sKV + stages * 2 * NC * KV_BOX);
  uint64_t* full_v = full_k + stages;
  uint64_t* empty = full_v + stages;
  uint64_t* q_full = empty + stages;

  const int iq = gridDim.x - 1 - blockIdx.x;   // heaviest q-blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = iq * BQ;
  const int nk = (S + BK - 1) / BK;
  const int k_hi = min(nk - 1, (q0 + BQ - 1) / BK);
  const int k_lo =
      (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;
  const int nblocks = k_hi - k_lo + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(q_full, NC * Q_BOX);
      for (int c = 0; c < NC; ++c)
        hopper::tma_load_4d(sQ + c * Q_BOX, &tm_q, q_full, 64 * c, h, q0, b);
      for (int i = 0; i < nblocks; ++i) {
        const int s = i % stages, use = i / stages;
        if (use > 0) hopper::mbar_wait(&empty[s], (use - 1) & 1);
        uint8_t* sK = sKV + s * 2 * NC * KV_BOX;
        uint8_t* sV = sK + NC * KV_BOX;
        const int k0 = (k_lo + i) * BK;
        hopper::mbar_expect_tx(&full_k[s], NC * KV_BOX);
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(sK + c * KV_BOX, &tm_k, &full_k[s], 64 * c, kh,
                              k0, b);
        hopper::mbar_expect_tx(&full_v[s], NC * KV_BOX);
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(sV + c * KV_BOX, &tm_v, &full_v[s], 64 * c, kh,
                              k0, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;   // this thread's rows: r0, r0 + 8
    const int wq = q0 + 64 * wg;                   // the warpgroup's first query
    const int qp0 = wq + r0, qp1 = qp0 + 8;
    const int wq_hi = min(wq + 63, S - 1);
    const int col0 = 2 * (lane % 4);
    // a score's log2-domain value is x * f: with a softcap x is the capped
    // score times log2(e) and f = 1, without one x is the raw product
    const bool capped = softcap > 0.f;
    const float s_mul = scale / softcap, c_mul = softcap * LOG2E;
    const float f = capped ? 1.f : scale * LOG2E;

    const uint32_t q_addr = hopper::smem_addr(sQ) + 64 * ROW * wg;
    float o[PN / 2];
#pragma unroll
    for (int i = 0; i < PN / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // log2 domain
    hopper::mbar_wait(q_full, 0);

    for (int i = 0; i < nblocks; ++i) {
      const int s = i % stages;
      const uint32_t par = (i / stages) & 1;
      const int k0 = (k_lo + i) * BK;
      const uint32_t k_addr = hopper::smem_addr(sKV + s * 2 * NC * KV_BOX);
      const uint32_t v_addr = k_addr + NC * KV_BOX;
      // does any (row, key) of this warpgroup meet the band in this block?
      const bool any = wq <= wq_hi && k0 <= wq_hi &&
                       (window <= 0 || wq - (k0 + BK - 1) < window);
      const bool edge = k0 + BK - 1 > wq || k0 + BK > S ||
                        (window > 0 && wq_hi - k0 >= window);
      hopper::mbar_wait(&full_k[s], par);
      if (any) {
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        hopper::wgmma_fence();
        for (int ks = 0; ks < ksteps; ++ks) {
          // 16 columns = 32 bytes along a swizzled row, a box per 4 steps
          const uint32_t off = (ks % 4) * 32;
          const uint64_t da =
              hopper::sw128_desc(q_addr + (ks / 4) * Q_BOX + off, 16, 1024);
          const uint64_t db =
              hopper::sw128_desc(k_addr + (ks / 4) * KV_BOX + off, 16, 1024);
          hopper::wgmma_ss_n64(sc, da, db, ks > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < 32; ++j) hopper::fence_operand(sc[j]);

        // scores (x, -inf off the band) and the rows' maxima
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float x = sc[j];
          if (capped) x = c_mul * tanh_ex2(x * s_mul);
          if (edge) {
            const int kp = k0 + 8 * (j / 4) + col0 + (j & 1);
            const int qp = (j & 2) ? qp1 : qp0;
            if (!(kp <= qp && kp < S && (window <= 0 || qp - kp < window)))
              x = -INFINITY;
          }
          sc[j] = x;
          if (j & 2) mx1 = fmaxf(mx1, x);
          else mx0 = fmaxf(mx0, x);
        }
#pragma unroll
        for (int w = 1; w <= 2; w <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
        }
        mx0 = fmaxf(m0, mx0 * f);
        mx1 = fmaxf(m1, mx1 * f);
        const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {    // p = 0 at -inf
          const float p = ex2(fmaf(sc[j], f, (j & 2) ? -m1 : -m0));
          sc[j] = p;
          if (j & 2) sum1 += p;
          else sum0 += p;
        }
        l0 = alpha0 * l0 + sum0;     // this thread's share of the row sums
        l1 = alpha1 * l1 + sum1;
        // rescale the accumulator only where a row's maximum moved (late
        // blocks rarely move it); the test is uniform across the warp
        if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
          for (int j = 0; j < PN / 2; ++j) o[j] *= (j & 2) ? alpha1 : alpha0;
        }

        // P as the A operand of 4 k16 steps, split into bf16 hi and lo terms
        uint32_t phi[16], plo[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          split_pair(sc[2 * j], sc[2 * j + 1], phi[j], plo[j]);

        hopper::mbar_wait(&full_v[s], par);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // 16 keys = 16 rows down; LBO steps from box to box of 64 columns
          const uint64_t db =
              hopper::sw128_desc(v_addr + kk * 16 * ROW, KV_BOX, 1024);
          wgmma_pv<PN>(o, &phi[4 * kk], db);
          wgmma_pv<PN>(o, &plo[4 * kk], db);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < PN / 2; ++j) hopper::fence_operand(o[j]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          hopper::fence_operand(phi[j]);
          hopper::fence_operand(plo[j]);
        }
      } else {
        hopper::mbar_wait(&full_v[s], par);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // l == 0 (nothing visible) divides by 1, as the TPU kernel does
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, w);
      l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    if (l0 == 0.f) l0 = 1.f;
    if (l1 == 0.f) l1 = 1.f;
    // bf16 out into this warpgroup's own q rows, in the swizzled layout
    uint8_t* sO = sQ + 64 * ROW * wg;
#pragma unroll
    for (int j = 0; j < PN / 4; ++j) {         // pairs of columns
      const int n = 8 * (j / 2) + col0;        // j / 2: an 8-column group
      const int r = (j & 1) ? r0 + 8 : r0;
      const float li = (j & 1) ? l1 : l0;
      const uint32_t v = pack_bf16(o[2 * j] / li, o[2 * j + 1] / li);
      const int c = n / 64, cc = n % 64;
      *reinterpret_cast<uint32_t*>(sO + c * Q_BOX + r * ROW +
                                   ((cc / 8) ^ (r % 8)) * 16 + (cc % 8) * 2) = v;
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (t == 0) {
      for (int c = 0; c < NC; ++c)
        hopper::tma_store_4d(&tm_o, sO + c * Q_BOX, 64 * c, h, wq, b);
      hopper::tma_store_commit_and_wait();
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: reached through the runtime's
// entry-point query, so the library needs no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, n, D) bf16, contiguous, as a 4-d tensor map (innermost first) with
// boxes of 64 columns x ``rows`` positions of one head, 128-byte swizzle;
// reads past S or D fill zeros, writes there are dropped
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int n, int D,
            int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n),
      static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * n, 2ull * D * n * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int ENCODE_FAILED = 1000;   // beyond every cudaError_t

template <int NC, int PN>
int launch(const CUtensorMap* maps, int B, int S, int H, int K, int ksteps,
           int stages, int smem, float scale, float softcap, int window,
           cudaStream_t stream) {
  auto kern = flash_attention_wgmma<NC, PN>;
  if (const int e = launch_once::allow_smem(
          reinterpret_cast<const void*>(kern), smem))
    return e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], S,
                                        H, K, ksteps, stages, scale, softcap,
                                        window);
  return static_cast<int>(cudaGetLastError());
}

int run(const void* q, const void* k, const void* v, void* out, int B, int S,
        int H, int K, int D, float scale, float softcap, int window, int dp,
        int stages, int smem, cudaStream_t stream) {
  const int nc = dp / 64;
  const size_t need = 1024 +
                      static_cast<size_t>(nc) * (Q_BOX + 2 * stages * KV_BOX) +
                      (3 * stages + 1) * sizeof(uint64_t);
  if (D % 8 || D > dp || dp % 64 || nc < 1 || nc > 4 || stages < 1 ||
      static_cast<size_t>(smem) < need)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!encode(&maps[0], q, B, S, H, D, BQ) ||
      !encode(&maps[1], k, B, S, K, D, BK) ||
      !encode(&maps[2], v, B, S, K, D, BK) ||
      !encode(&maps[3], out, B, S, H, D, 64))
    return ENCODE_FAILED;
  const int ksteps = (D + 15) / 16;
#define FA_ARGS \
  maps, B, S, H, K, ksteps, stages, smem, scale, softcap, window, stream
  switch (D) {                 // the configs' head_dims that are no DP
    case 80: return launch<2, 80>(FA_ARGS);
    case 96: return launch<2, 96>(FA_ARGS);
    case 120: return launch<2, 120>(FA_ARGS);
    case 160: return launch<3, 160>(FA_ARGS);
  }
  switch (nc) {
    case 1: return launch<1, 64>(FA_ARGS);
    case 2: return launch<2, 128>(FA_ARGS);
    case 3: return launch<3, 192>(FA_ARGS);
    default: return launch<4, 256>(FA_ARGS);
  }
#undef FA_ARGS
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  q and out are
// (B,S,H,D), k and v (B,S,K,D), all contiguous; H % K == 0.  The launch
// plan comes from the wrapper (ops.py launch_plan): dp, the padded head_dim
// of the bf16 kernel (a multiple of 64 >= D; D a multiple of 8, pointers
// 16-byte aligned), its ring stages, and the dynamic shared memory of a CTA
// (either kernel), each checked here.  f32 takes 1 <= D <= 256.  softcap <= 0
// and window <= 0 mean "none".  Returns cudaGetLastError() after the launch
// (0 = launched), cudaErrorInvalidValue for a plan or input the kernel does
// not take, or 1000 if a TMA tensor map could not be encoded.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int S, int H,
                               int K, int D, float scale, float softcap,
                               int window, int dp, int stages, int smem,
                               void* stream) {
  if (B == 0 || S == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return simt::run(q, k, v, out, B, S, H, K, D, scale, softcap, window,
                       smem, s);
    case 1:
      return tc::run(q, k, v, out, B, S, H, K, D, scale, softcap, window, dp,
                     stages, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
