// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces the TPU kernel kernels/ssd/kernel.py ssd_fwd (body _kernel) of the
// JAX package, with the two operands the JAX model's ssd_chunked adds: an
// optional initial state h0 and f32 outputs.  Over chunks of Q steps:
//   cum_a  = prefix sum of dt·A over the chunk                         (f32)
//   y_i    = sum_{j <= i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j         intra
//          + exp(cum_i) C_i·h_prev^T                                   inter
//          + D·x_i                                       (only when D given)
//   h      = exp(cum_end) h_prev + x^T (B ⊙ exp(cum_end - cum) ⊙ dt)    carry
// B and C (B,S,N) are shared by every head (n_groups = 1); x (B,S,H,P) and
// B, C are float32 or bfloat16 (one dtype), dt (B,S,H) and A (H,) float32;
// y (B,S,H,P) and h_final (B,H,P,N) are written as f32, so a bf16 model
// rounds y once, after its own D-term, as ssd_chunked's caller does.  A
// ragged last chunk reads dt = 0 and zeros past S, which leaves the state
// unchanged; its rows past S are not written.
//
// What bounds it: bytes, at the least.  A mamba2-1.3b layer at S = 4500
// (H = 64, P = 64, N = 128, Q = 256) needs ~1.4e10 flops (C·B^T once per
// chunk, the causal half of each chunk's scores) against ~1.2e8 bytes in
// and out: about 120 flops per byte, under the card's ~300 bf16 flops per
// byte, so the least time is the bytes' (~0.035 ms on an H100).  The TPU
// kernel walks the chunks in order on one core; carried over as it was (the
// f32 kernel below), one CTA per (head, batch row) left 64 CTAs on 132 SMs,
// ran every product as an f32 FMA and formed C·B^T again for every head.
//
// Design.  The bf16 route follows the stages of ssd_chunked, not the TPU
// grid; only one short pass is sequential, and the products run on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulation):
// 1. ssd_cb_kernel, grid (causal 64 x 64 tiles, chunk, batch): C·B^T once
//    per (batch, chunk) for every head, into a (B, NC, Qp, Qp) f32
//    workspace (Qp = Q padded to 64).
//    ssd_state_kernel, grid (head, chunk, batch): cum_a (a block scan),
//    written to a (B, NC, H, Qp) workspace, and the chunk state
//    s_c = x^T (B ⊙ w), w_j = exp(cum_end - cum_j) dt_j, a (P, N) tile,
//    written to a (B, NC, H, P, N) workspace; the next 64-step tile's x and
//    B are in flight while one tile's products run.
// 2. ssd_pass_kernel, grid (slices of P·N, head, batch): NC elementwise f32
//    steps h_prev[c] = h, h = exp(cum_end_c) h + s_c from h0 or zeros; it
//    writes h_prev over s_c and h_final.
// 3. ssd_scan_kernel, grid (head, chunk, batch): eight warps split h_prev
//    into hi + lo once; then two groups of four warps share the chunk's
//    64-row tiles (longest first, each to the group with less work), and
//    for each tile form the inter term C_i·h_prev^T scaled by exp(cum_i),
//    then the intra term, the weighted scores (formed in registers, in the
//    A-fragment layout) times the x tiles j <= i; plus D·x; y written in
//    f32.  A group's next C tile and next x tile load while it computes.
//    One CTA per (chunk, head) and not per row tile: h_prev is read from
//    the workspace and split once, not once per row tile.
// Precision: x, B and C arrive in bf16, so C·B^T and every product with x
// are exact products with f32 accumulation.  Three operands are f32: the
// weighted scores, h_prev and B ⊙ w.  Each is split into bf16 hi + lo
// (lo = bf16(v - hi)) and enters two products, which keeps about 16
// significant bits (the plain version rounds them nowhere; the check holds
// y and h_final to 5e-4 + 1e-3 |plain|).  The decay exp(cum_i - cum_j) is
// formed only where j <= i: above the diagonal it may overflow (inf·0 is
// NaN); exp(cum_i) exp(-cum_j) is never formed as two factors.
// Q may be any length (a ragged Q is padded to 64 rows with zeros in shared
// memory), P any of 1..64 and N 1..128 (padded to 16 with zeros).  No
// atomics: every sum runs in a fixed order, so y and h_final are the same
// bits from call to call.  All four kernels run on the caller's stream; the
// workspace comes from the caller, so a call allocates nothing.  What is
// left between them and the bound: the hi/lo products double the
// tensor-core work, the score and split arithmetic runs on the CUDA cores
// beside it, and the f32 workspace (states, h_prev, C·B^T) is written and
// read back once.
// The f32 route keeps the first port's kernel (ssd_fma_kernel: one CTA per
// (head, batch row) walking the chunks, f32 FMAs); no served path runs it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "launch_once.cuh"

namespace {

constexpr int MAX_P = 64;           // head_dim
constexpr int MAX_N = 128;          // state

// ===================================================== f32: the FMA kernel
namespace simt {

constexpr int TILE = 64;            // rows of a chunk tile, columns of a score tile
constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RI = TILE / TY;       // rows per thread
constexpr int CJ = TILE / TX;       // score / output columns per thread
constexpr int NJ = MAX_N / TX;      // state columns per thread
constexpr int SP = TILE + 1;        // padded stride of the score tile

// Copies rows 0..rows-1 (rows <= TILE) of a (.., cols) slice whose rows are
// row_stride elements apart into dst (row stride dst_stride), and zeros
// into rows rows..TILE-1.  Columns at or past cols are not touched.  Each
// thread keeps LU loads in flight before it stores.
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int dst_stride,
                                          const float* __restrict__ src,
                                          size_t row_stride, int rows, int cols,
                                          int tid) {
  constexpr int LU = 8;
  const int n = TILE * cols;
  for (int e0 = tid; e0 < n; e0 += THREADS * LU) {
    float v[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int e = e0 + u * THREADS;
      const int r = e / cols, c = e - r * cols;
      v[u] = (e < n && r < rows) ? src[r * row_stride + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int e = e0 + u * THREADS;
      const int r = e / cols, c = e - r * cols;
      if (e < n) dst[r * dst_stride + c] = v[u];
    }
  }
}

__host__ __device__ size_t smem_floats(int N, int Qp) {
  return 3 * static_cast<size_t>(TILE) * (N + 1)   // h (MAX_P rows), C, B tiles
         + static_cast<size_t>(TILE) * MAX_P       // x tile
         + static_cast<size_t>(TILE) * SP          // scores (and carry weights)
         + 3 * static_cast<size_t>(Qp);            // dt, cum_a, scan buffer
}

__global__ void __launch_bounds__(THREADS) ssd_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ h_final, int S, int H, int P, int N, int Q, int Qp) {
  extern __shared__ float smem[];
  const int NS = N + 1;
  float* sH = smem;                 // (MAX_P, N+1) state, rows >= P stay 0
  float* sC = sH + TILE * NS;       // (TILE, N+1) C rows of the row tile
  float* sB = sC + TILE * NS;       // (TILE, N+1) B rows of the column tile
  float* sX = sB + TILE * NS;       // (TILE, MAX_P) x rows, columns >= P stay 0
  float* sS = sX + TILE * MAX_P;    // (TILE, SP) weighted scores
  float* sDt = sS + TILE * SP;      // (Qp) dt of the chunk, 0 past its rows
  float* bufA = sDt + Qp;           // (Qp) cum_a, and the scan's other buffer
  float* bufB = bufA + Qp;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid - ty * TX;
  const float a_h = A[h];
  const float d_h = D != nullptr ? D[h] : 0.f;
  const size_t x_row = static_cast<size_t>(H) * P;   // stride between steps
  const float* xb = x + static_cast<size_t>(b) * S * x_row + static_cast<size_t>(h) * P;
  const float* Bb = Bm + static_cast<size_t>(b) * S * N;
  const float* Cb = Cm + static_cast<size_t>(b) * S * N;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  float* yb = y + static_cast<size_t>(b) * S * x_row + static_cast<size_t>(h) * P;
  const size_t h_off = (static_cast<size_t>(b) * H + h) * P * N;

  for (size_t e = tid; e < smem_floats(N, Qp); e += THREADS) smem[e] = 0.f;
  __syncthreads();
  if (h0 != nullptr)
    for (int e = tid; e < P * N; e += THREADS) {
      const int p = e / N, n = e - p * N;
      sH[p * NS + n] = h0[h_off + e];
    }

  const int nblk = Qp / TILE;
  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    const int valid = min(Q, S - s0);       // steps of this chunk inside S
    __syncthreads();                        // the last chunk's readers are done
    for (int i = tid; i < Qp; i += THREADS) {
      const float d = i < valid ? dtb[static_cast<size_t>(s0 + i) * H] : 0.f;
      sDt[i] = d;
      bufA[i] = d * a_h;
    }
    __syncthreads();
    float* cum = bufA;
    float* tmp = bufB;
    for (int off = 1; off < Qp; off <<= 1) {
      for (int i = tid; i < Qp; i += THREADS)
        tmp[i] = cum[i] + (i >= off ? cum[i - off] : 0.f);
      __syncthreads();
      float* t = cum;
      cum = tmp;
      tmp = t;
    }
    const float cum_end = cum[Q - 1];

    // ---------------------------------------------------------- outputs
    for (int ib = 0; ib < nblk; ++ib) {
      const int i0 = ib * TILE;
      const int rows_i = max(0, min(TILE, valid - i0));
      if (rows_i == 0) break;               // the rest of the chunk is past S
      __syncthreads();                      // the last tile's readers of sC are done
      load_tile(sC, NS, Cb + static_cast<size_t>(s0 + i0) * N, N, rows_i, N, tid);
      __syncthreads();

      // inter-chunk term: exp(cum_i) C_i·h_prev^T
      float acc[RI][CJ];
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[a][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float ca[RI], hb[CJ];
#pragma unroll
        for (int a = 0; a < RI; ++a) ca[a] = sC[(ty + TY * a) * NS + n];
#pragma unroll
        for (int j = 0; j < CJ; ++j) hb[j] = sH[(tx + TX * j) * NS + n];
#pragma unroll
        for (int a = 0; a < RI; ++a)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[a][j] = fmaf(ca[a], hb[j], acc[a][j]);
      }
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const float e = expf(cum[i0 + ty + TY * a]);
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[a][j] *= e;
      }

      // intra-chunk term over the column tiles j <= i
      for (int jb = 0; jb <= ib; ++jb) {
        const int j0 = jb * TILE;
        const int rows_j = max(0, min(TILE, valid - j0));
        __syncthreads();                    // the last tile's readers are done
        load_tile(sB, NS, Bb + static_cast<size_t>(s0 + j0) * N, N, rows_j, N, tid);
        load_tile(sX, MAX_P, xb + static_cast<size_t>(s0 + j0) * x_row, x_row,
                  rows_j, P, tid);
        __syncthreads();
        float sc[RI][CJ];
#pragma unroll
        for (int a = 0; a < RI; ++a)
#pragma unroll
          for (int j = 0; j < CJ; ++j) sc[a][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float ca[RI], bb[CJ];
#pragma unroll
          for (int a = 0; a < RI; ++a) ca[a] = sC[(ty + TY * a) * NS + n];
#pragma unroll
          for (int j = 0; j < CJ; ++j) bb[j] = sB[(tx + TX * j) * NS + n];
#pragma unroll
          for (int a = 0; a < RI; ++a)
#pragma unroll
            for (int j = 0; j < CJ; ++j) sc[a][j] = fmaf(ca[a], bb[j], sc[a][j]);
        }
#pragma unroll
        for (int a = 0; a < RI; ++a) {
          const int ri = i0 + ty + TY * a;
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            const int cj = j0 + tx + TX * j;
            // the decay only on j <= i: above the diagonal exp may overflow
            const float w = cj <= ri ? expf(cum[ri] - cum[cj]) * sDt[cj] : 0.f;
            sS[(ty + TY * a) * SP + tx + TX * j] = sc[a][j] * w;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < TILE; ++k) {
          float sa[RI], xv[CJ];
#pragma unroll
          for (int a = 0; a < RI; ++a) sa[a] = sS[(ty + TY * a) * SP + k];
#pragma unroll
          for (int j = 0; j < CJ; ++j) xv[j] = sX[k * MAX_P + tx + TX * j];
#pragma unroll
          for (int a = 0; a < RI; ++a)
#pragma unroll
            for (int j = 0; j < CJ; ++j) acc[a][j] = fmaf(sa[a], xv[j], acc[a][j]);
        }
      }
      // sX now holds the x rows of this row tile (the last jb is ib)
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const int r = ty + TY * a;
        if (r >= rows_i) continue;
        float* yr = yb + static_cast<size_t>(s0 + i0 + r) * x_row;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int p = tx + TX * j;
          if (p < P) yr[p] = D != nullptr ? acc[a][j] + d_h * sX[r * MAX_P + p]
                                          : acc[a][j];
        }
      }
    }

    // ----------------------------------------------------- state carry
    float hacc[RI][NJ];
#pragma unroll
    for (int a = 0; a < RI; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) hacc[a][j] = 0.f;
    float* sW = sS;                         // (TILE) carry weights of a tile
    for (int jb = 0; jb < nblk; ++jb) {
      const int j0 = jb * TILE;
      const int rows_j = max(0, min(TILE, valid - j0));
      if (rows_j == 0) break;               // dt = 0 there: no contribution
      __syncthreads();                      // readers of sB / sX / sS are done
      load_tile(sB, NS, Bb + static_cast<size_t>(s0 + j0) * N, N, rows_j, N, tid);
      load_tile(sX, MAX_P, xb + static_cast<size_t>(s0 + j0) * x_row, x_row,
                rows_j, P, tid);
      for (int k = tid; k < TILE; k += THREADS)
        sW[k] = expf(cum_end - cum[j0 + k]) * sDt[j0 + k];
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < TILE; ++k) {
        const float wk = sW[k];
        float xa[RI], bb[NJ];
#pragma unroll
        for (int a = 0; a < RI; ++a) xa[a] = sX[k * MAX_P + ty + TY * a] * wk;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = tx + TX * j;
          bb[j] = n < N ? sB[k * NS + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < RI; ++a)
#pragma unroll
          for (int j = 0; j < NJ; ++j) hacc[a][j] = fmaf(xa[a], bb[j], hacc[a][j]);
      }
    }
    // every row tile has read h_prev (the syncs of the carry loop lie between)
    const float decay = expf(cum_end);
#pragma unroll
    for (int a = 0; a < RI; ++a) {
      const int p = ty + TY * a;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + TX * j;
        if (n < N) sH[p * NS + n] = sH[p * NS + n] * decay + hacc[a][j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    h_final[h_off + e] = sH[p * NS + n];
  }
}


int launch_fma(const float* x, const float* dt, const float* A, const float* Bm,
               const float* Cm, const float* D, const float* h0, float* y,
               float* h_final, int Bsz, int S, int H, int P, int N, int Q,
               cudaStream_t stream) {
  const int Qp = (Q + TILE - 1) / TILE * TILE;
  const size_t smem = smem_floats(N, Qp) * sizeof(float);
  if (const int e = launch_once::allow_smem(
          reinterpret_cast<const void*>(ssd_fma_kernel), smem))
    return e;
  ssd_fma_kernel<<<dim3(H, Bsz), THREADS, smem, stream>>>(
      x, dt, A, Bm, Cm, D, h0, y, h_final, S, H, P, N, Q, Qp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ================================================ bf16: the tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_bf16_16816;

constexpr int ROWS = 64;          // rows of a chunk tile (Q padded to it)
constexpr int XS = MAX_P + 8;     // shared row stride (bf16) of an x tile
constexpr int NS = MAX_N + 8;     // ... of a B, C or h tile: 16-byte rows
                                  // 16 bytes apart in the banks (ldmatrix)
constexpr int STATE_THREADS = 256, SCAN_THREADS = 256, CB_THREADS = 128;
constexpr int PASS_THREADS = 256, PASS_AHEAD = 8;

// (a, b) as bf16 hi + lo pairs: hi = bf16(v), lo = bf16(v - hi); the low
// half of each word holds a
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = reinterpret_cast<const uint32_t&>(h);
  lo = reinterpret_cast<const uint32_t&>(l);
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  // a bf16 is the top half of the f32 with the same bits
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Rows 0..ROWS-1 of a bf16 slice (row r at src + r * stride, cols
// elements) into dst (row stride ds), zeros in rows >= valid; columns >=
// cols are not touched.  vec: cols % 8 == 0 and 16-byte aligned rows, so
// each 16-byte piece is one cp.async (zero-filled past valid), which the
// caller commits and waits for; otherwise plain loads and stores.  Either
// way the caller syncs before other threads read dst.
template <int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, int ds,
                                           const bf16* __restrict__ src,
                                           size_t stride, int valid, int cols,
                                           bool vec, int tid) {
  if (vec) {
    const int cpr = cols >> 3;
    for (int e = tid; e < ROWS * cpr; e += NT) {
      const int r = e / cpr, q = e - r * cpr;
      const bool ok = r < valid;
      hopper::cp_async<16>(dst + r * ds + q * 8,
                           ok ? src + r * stride + q * 8 : src, ok);
    }
  } else {
    for (int e = tid; e < ROWS * cols; e += NT) {
      const int r = e / cols, q = e - r * cols;
      dst[r * ds + q] = r < valid ? src[r * stride + q] : __float2bfloat16(0.f);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_shared(void* p, int bytes, int tid) {
  uint4* q = static_cast<uint4*>(p);
  for (int e = tid; e < bytes / 16; e += NT) q[e] = make_uint4(0, 0, 0, 0);
}

// Inclusive prefix sum of buf[0..n) in place (n a multiple of 32): warp
// scans by shuffles, then each warp adds the totals of the warps before it
// and of the earlier segments.  tot holds NT / 32 floats.  Ends synced.
template <int NT>
__device__ __forceinline__ void block_cumsum(float* buf, int n, float* tot,
                                             int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < n; base += NT) {
    const int i = base + tid;
    float v = i < n ? buf[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) tot[warp] = v;
    __syncthreads();
    float pre = carry, all = carry;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) pre += tot[w];
      all += tot[w];
    }
    if (i < n) buf[i] = pre + v;
    carry = all;
    __syncthreads();
  }
}

// ------------------------------------------------------- stage 1: C·B^T
// One 64 x 64 tile (ib >= jb) of C·B^T for chunk blockIdx.y of batch row
// blockIdx.z: warp w computes rows 16w..16w+15, all 64 columns.
__global__ void __launch_bounds__(CB_THREADS) ssd_cb_kernel(
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    float* __restrict__ cb, int S, int N, int Q, int Qp, int NC, int vec_bc) {
  __shared__ __align__(16) bf16 sC[ROWS * NS];
  __shared__ __align__(16) bf16 sB[ROWS * NS];
  int jb = blockIdx.x, ib = 0;
  while (jb > ib) jb -= ++ib;               // the causal tile's (ib, jb)
  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = c * Q, valid = min(Q, S - s0);
  const int i0 = ib * ROWS, j0 = jb * ROWS;
  if (i0 >= valid) return;                  // no row of the scan reads it
  if (N & 15) {                               // padded columns read as 0
    zero_shared<CB_THREADS>(sC, sizeof(sC), tid);
    zero_shared<CB_THREADS>(sB, sizeof(sB), tid);
    __syncthreads();
  }
  const bf16* rows = Cm + (static_cast<size_t>(b) * S + s0) * N;
  copy_rows<CB_THREADS>(sC, NS, rows + static_cast<size_t>(i0) * N, N,
                         min(ROWS, valid - i0), N, vec_bc, tid);
  rows = Bm + (static_cast<size_t>(b) * S + s0) * N;
  copy_rows<CB_THREADS>(sB, NS, rows + static_cast<size_t>(j0) * N, N,
                         min(ROWS, valid - j0), N, vec_bc, tid);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;
  const int mi = lane >> 3;
  for (int k0 = 0; k0 < N; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, sC + (16 * warp + (lane & 7) + (mi & 1) * 8) * NS + k0 +
                       (mi >> 1) * 8);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t bb[4];
      ldmatrix_x4(bb, sB + (16 * q + (mi >> 1) * 8 + (lane & 7)) * NS + k0 +
                          (mi & 1) * 8);
      mma_bf16_16816(acc[2 * q], a, bb[0], bb[1]);
      mma_bf16_16816(acc[2 * q + 1], a, bb[2], bb[3]);
    }
  }
  const int g = lane >> 2, t4 = lane & 3;
  float* out = cb + (static_cast<size_t>(b) * NC + c) * Qp * Qp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* row = out + static_cast<size_t>(i0 + 16 * warp + g + 8 * half) * Qp
                 + j0 + 2 * t4;
#pragma unroll
    for (int t = 0; t < 8; ++t)
      *reinterpret_cast<float2*>(row + 8 * t) =
          make_float2(acc[t][2 * half], acc[t][2 * half + 1]);
  }
}

__host__ __device__ constexpr size_t state_smem(int Qp) {
  return sizeof(bf16) * (2 * ROWS * XS + 2 * ROWS * NS)   // x (two buffers),
                                                          // (B ⊙ w) hi, lo
         + sizeof(float) * (32 + 2 * Qp);                 // totals, cum, dt
}

// ------------------------------------------------- stage 1: chunk state
// cum_a of chunk blockIdx.y, head blockIdx.x, batch row blockIdx.z, and its
// state s_c = x^T (B ⊙ w): warp w owns state rows 16 (w % 4).. (of P) and
// columns 64 (w / 4).. (of N).  The 64-step tiles of the chunk stream
// through shared memory: while one tile's products run, the next tile's x
// is in flight (cp.async, two buffers) and its B rows in registers.
__global__ void __launch_bounds__(STATE_THREADS) ssd_state_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ cum_out, int S, int H,
    int P, int N, int Q, int Qp, int NC, int vec_x, int vec_bc) {
  constexpr int NT = STATE_THREADS;
  constexpr int BV = ROWS * (MAX_N / 8) / NT;   // 16-byte B pieces a thread
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sX0 = reinterpret_cast<bf16*>(smem);  // 2 x (ROWS, XS) x rows
  bf16* sBh = sX0 + 2 * ROWS * XS;            // (ROWS, NS) B ⊙ w, hi
  bf16* sBl = sBh + ROWS * NS;                // (ROWS, NS) B ⊙ w, lo
  float* sTot = reinterpret_cast<float*>(sBl + ROWS * NS);   // (32) totals
  float* sCum = sTot + 32;                    // (Qp) cum_a
  float* sDt = sCum + Qp;                     // (Qp) dt, 0 past the chunk
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = c * Q, valid = min(Q, S - s0);
  const size_t slot = (static_cast<size_t>(b) * NC + c) * H + h;
  const size_t x_row = static_cast<size_t>(H) * P;
  const bf16* xc = x + (static_cast<size_t>(b) * S + s0) * x_row +
                   static_cast<size_t>(h) * P;
  const bf16* bc = Bm + (static_cast<size_t>(b) * S + s0) * N;
  const int cpr = N >> 3;                     // 16-byte pieces of a B row

  if ((P | N) & 15)                           // padded columns read as 0
    zero_shared<NT>(smem, sizeof(bf16) * (2 * ROWS * XS + 2 * ROWS * NS),
                    tid);
  const float a_h = A[h];
  const float* dtc = dt + (static_cast<size_t>(b) * S + s0) * H + h;
  for (int i = tid; i < Qp; i += NT) {
    const float d = i < valid ? dtc[static_cast<size_t>(i) * H] : 0.f;
    sDt[i] = d;
    sCum[i] = d * a_h;
  }
  __syncthreads();                            // also orders the zeroing
  copy_rows<NT>(sX0, XS, xc, x_row, min(ROWS, valid), P, vec_x, tid);
  hopper::cp_async_commit();
  uint4 braw[BV];                             // this tile's B rows (vec_bc)
  auto load_b = [&](int j0, int rows) {
#pragma unroll
    for (int k = 0; k < BV; ++k) {
      const int e = tid + k * NT;
      braw[k] = make_uint4(0, 0, 0, 0);
      if (vec_bc && e < ROWS * cpr) {
        const int r = e / cpr, q = e - r * cpr;
        if (r < rows)
          braw[k] = *reinterpret_cast<const uint4*>(
              bc + static_cast<size_t>(j0 + r) * N + 8 * q);
      }
    }
  };
  load_b(0, min(ROWS, valid));
  block_cumsum<NT>(sCum, Qp, sTot, tid);
  for (int i = tid; i < Qp; i += NT) cum_out[slot * Qp + i] = sCum[i];
  const float cum_end = sCum[Q - 1];

  const int pt = warp & 3, n_base = (warp >> 2) * 64;
  const bool active = 16 * pt < P;
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;
  const int mi = lane >> 3;
  for (int j0 = 0, t = 0; j0 < valid; j0 += ROWS, ++t) {
    const int rows = min(ROWS, valid - j0);
    const bool more = j0 + ROWS < valid;
    __syncthreads();                          // the last tile's readers
    // B ⊙ w (w_j = exp(cum_end - cum_j) dt_j), split into bf16 hi + lo
    if (vec_bc) {
#pragma unroll
      for (int k = 0; k < BV; ++k) {
        const int e = tid + k * NT, r = e / cpr, q = e - r * cpr;
        if (e >= ROWS * cpr) break;
        const float w = expf(cum_end - sCum[j0 + r]) * sDt[j0 + r];
        const uint32_t words[4] = {braw[k].x, braw[k].y, braw[k].z,
                                   braw[k].w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = bf16x2_to_float2(words[u]);
          split2(f.x * w, f.y * w, hi[u], lo[u]);
        }
        *reinterpret_cast<uint4*>(sBh + r * NS + 8 * q) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(sBl + r * NS + 8 * q) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    } else {
      for (int e = tid; e < ROWS * N; e += NT) {
        const int r = e / N, q = e - r * N;
        const float v = r < rows
            ? __bfloat162float(bc[static_cast<size_t>(j0 + r) * N + q]) *
                  (expf(cum_end - sCum[j0 + r]) * sDt[j0 + r])
            : 0.f;
        const bf16 hi = __float2bfloat16_rn(v);
        sBh[r * NS + q] = hi;
        sBl[r * NS + q] = __float2bfloat16_rn(v - __bfloat162float(hi));
      }
    }
    if (more) {                               // the next tile, in flight
      copy_rows<NT>(sX0 + ((t + 1) & 1) * ROWS * XS, XS,
                     xc + (j0 + ROWS) * x_row, x_row,
                     min(ROWS, valid - j0 - ROWS), P, vec_x, tid);
      hopper::cp_async_commit();
      load_b(j0 + ROWS, min(ROWS, valid - j0 - ROWS));
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    if (!active) continue;
    const bf16* sX = sX0 + (t & 1) * ROWS * XS;
    for (int k0 = 0; k0 < rows; k0 += 16) {   // steps past the rows: zeros
      uint32_t a[4];                          // x^T: rows p, columns j
      ldmatrix_x4_trans(a, sX + (k0 + (mi >> 1) * 8 + (lane & 7)) * XS +
                               16 * pt + (mi & 1) * 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n0 = n_base + 16 * q;
        if (n0 >= N) break;
        const int off = (k0 + (mi & 1) * 8 + (lane & 7)) * NS + n0 +
                        (mi >> 1) * 8;
        uint32_t bh[4], bl[4];
        ldmatrix_x4_trans(bh, sBh + off);
        ldmatrix_x4_trans(bl, sBl + off);
        mma_bf16_16816(acc[2 * q], a, bh[0], bh[1]);
        mma_bf16_16816(acc[2 * q], a, bl[0], bl[1]);
        mma_bf16_16816(acc[2 * q + 1], a, bh[2], bh[3]);
        mma_bf16_16816(acc[2 * q + 1], a, bl[2], bl[3]);
      }
    }
  }
  if (!active) return;
  const int g = lane >> 2, t4 = lane & 3;
  float* out = states + slot * P * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = 16 * pt + g + 8 * half;
    if (p >= P) continue;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int n = n_base + 8 * t + 2 * t4;
      const float v0 = acc[t][2 * half], v1 = acc[t][2 * half + 1];
      if ((N & 1) == 0 && n < N) {
        *reinterpret_cast<float2*>(out + p * N + n) = make_float2(v0, v1);
      } else {
        if (n < N) out[p * N + n] = v0;
        if (n + 1 < N) out[p * N + n + 1] = v1;
      }
    }
  }
}

// ------------------------------------------------------- stage 2: pass
// One state element of (batch row blockIdx.z, head blockIdx.y) per thread,
// over the chunks in order: PASS_AHEAD chunks' states and decays are
// loaded before their steps run.  The step rounds as the plain version
// does: exp(cum_end)·h, then + s_c.
__global__ void __launch_bounds__(PASS_THREADS) ssd_pass_kernel(
    float* __restrict__ states, const float* __restrict__ cum,
    const float* __restrict__ h0, float* __restrict__ h_final, int H, int PN,
    int Q, int Qp, int NC) {
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = static_cast<size_t>(b) * H + h;
  float v = h0 != nullptr ? h0[bh * PN + e] : 0.f;
  for (int c0 = 0; c0 < NC; c0 += PASS_AHEAD) {
    float s[PASS_AHEAD], d[PASS_AHEAD];
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      const size_t slot = (static_cast<size_t>(b) * NC + c0 + k) * H + h;
      if (c0 + k < NC) {
        s[k] = states[slot * PN + e];
        d[k] = cum[slot * Qp + Q - 1];
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      const size_t slot = (static_cast<size_t>(b) * NC + c0 + k) * H + h;
      if (c0 + k < NC) {
        states[slot * PN + e] = v;
        v = __fadd_rn(__fmul_rn(expf(d[k]), v), s[k]);
      }
    }
  }
  h_final[bh * PN + e] = v;
}

__host__ __device__ constexpr size_t scan_smem(int Qp) {
  return sizeof(bf16) * (2 * MAX_P * NS                    // h hi and lo
                         + 2 * (ROWS * NS + 2 * ROWS * XS))  // a group's C,
                                                             // two x tiles
         + sizeof(float) * 2 * Qp;                         // cum, dt
}

// The row tiles of a chunk, longest first, each to the group of four warps
// with less work so far (a tile of row block ib costs ib + 2: its ib + 1
// score tiles and the inter term); returns the first tile after ``after``
// (or from the top with after = nblk) that goes to ``group``, or -1.
__device__ __forceinline__ int next_tile(int nblk, int group, int after) {
  int load0 = 0, load1 = 0;
  for (int ib = nblk - 1; ib >= 0; --ib) {
    const int g = load0 <= load1 ? 0 : 1;
    (g == 0 ? load0 : load1) += ib + 2;
    if (g == group && ib < after) return ib;
  }
  return -1;
}

// --------------------------------------------------- stage 3: chunk scan
// Chunk blockIdx.y, head blockIdx.x, batch row blockIdx.z.  All eight warps
// split h_prev into bf16 hi + lo once; then each group of four warps takes
// its row tiles (next_tile), warp w of the group owning rows 16w..16w+15
// of a tile and every column p.  A group's next C tile is in flight while
// the scores of the current one run, and each x tile while the one before
// it is multiplied (two buffers a group).
__global__ void __launch_bounds__(SCAN_THREADS, 2) ssd_scan_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const bf16* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ cb, const float* __restrict__ h_prev,
    const float* __restrict__ cum, float* __restrict__ y, int S, int H,
    int P, int N, int Q, int Qp, int NC, int vec_x, int vec_bc) {
  constexpr int NT = SCAN_THREADS, GT = NT / 2;   // threads, a group's
  constexpr int HV = MAX_P * MAX_N / 4 / NT;      // float4 pieces of h a thread
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sHh = reinterpret_cast<bf16*>(smem);  // (MAX_P, NS) h_prev, hi
  bf16* sHl = sHh + MAX_P * NS;               // (MAX_P, NS) h_prev, lo
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = warp >> 2, gw = warp & 3, gtid = tid & (GT - 1);
  bf16* sC = sHl + MAX_P * NS + group * (ROWS * NS + 2 * ROWS * XS);
  bf16* sX0 = sC + ROWS * NS;                 // 2 x (ROWS, XS) x rows
  float* sCum = reinterpret_cast<float*>(sHl + MAX_P * NS +
                                         2 * (ROWS * NS + 2 * ROWS * XS));
  float* sDt = sCum + Qp;                     // (Qp), 0 past the chunk
  const int s0 = c * Q, valid = min(Q, S - s0);
  const int nblk = (valid + ROWS - 1) / ROWS;  // row tiles inside S
  const size_t slot = (static_cast<size_t>(b) * NC + c) * H + h;
  const size_t x_row = static_cast<size_t>(H) * P;
  const bf16* xc = x + (static_cast<size_t>(b) * S + s0) * x_row +
                   static_cast<size_t>(h) * P;
  const bf16* cc = Cm + (static_cast<size_t>(b) * S + s0) * N;
  auto barrier = [&]() { hopper::named_barrier(1 + group, GT); };

  if ((P | N) & 15)                           // padded columns read as 0
    zero_shared<NT>(smem, sizeof(bf16) * (2 * MAX_P * NS +
                                          2 * (ROWS * NS + 2 * ROWS * XS)),
                    tid);
  __syncthreads();
  int ib = next_tile(nblk, group, nblk);
  if (ib >= 0) {
    copy_rows<GT>(sC, NS, cc + static_cast<size_t>(ib) * ROWS * N, N,
                   min(ROWS, valid - ib * ROWS), N, vec_bc, gtid);
    copy_rows<GT>(sX0, XS, xc, x_row, min(ROWS, valid), P, vec_x, gtid);
    hopper::cp_async_commit();
  }
  const float* dtc = dt + (static_cast<size_t>(b) * S + s0) * H + h;
  for (int i = tid; i < nblk * ROWS; i += NT) {
    sCum[i] = cum[slot * Qp + i];
    sDt[i] = i < valid ? dtc[static_cast<size_t>(i) * H] : 0.f;
  }
  // h_prev (P, N) f32, split into bf16 hi + lo; every load in flight first
  const float* hp = h_prev + slot * P * N;
  if ((N & 3) == 0) {
    float4 v[HV];
#pragma unroll
    for (int k = 0; k < HV; ++k) {
      const int e = 4 * (tid + k * NT);
      if (e < P * N) v[k] = *reinterpret_cast<const float4*>(hp + e);
    }
#pragma unroll
    for (int k = 0; k < HV; ++k) {
      const int e = 4 * (tid + k * NT);
      if (e >= P * N) break;
      const int p = e / N, n = e - p * N;
      uint32_t hi[2], lo[2];
      split2(v[k].x, v[k].y, hi[0], lo[0]);
      split2(v[k].z, v[k].w, hi[1], lo[1]);
      *reinterpret_cast<uint2*>(sHh + p * NS + n) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(sHl + p * NS + n) = make_uint2(lo[0], lo[1]);
    }
  } else {
    for (int e = tid; e < P * N; e += NT) {
      const int p = e / N, n = e - p * N;
      const bf16 hi = __float2bfloat16_rn(hp[e]);
      sHh[p * NS + n] = hi;
      sHl[p * NS + n] = __float2bfloat16_rn(hp[e] - __bfloat162float(hi));
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();

  const int mi = lane >> 3, g = lane >> 2, t4 = lane & 3;
  const int npairs = (P + 15) >> 4;
  const float d_h = D != nullptr ? D[h] : 0.f;
  const float* cbc = cb + (static_cast<size_t>(b) * NC + c) * Qp * Qp;
  int buf = 0;                                // the x buffer of the next tile
  for (bool first = true; ib >= 0; first = false) {
    const int i0 = ib * ROWS;
    if (!first) {                             // C and x tile 0 have landed
      hopper::cp_async_wait<0>();
      barrier();
    }
    float acc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;

    // inter-chunk term: C_i·h_prev^T, then exp(cum_i) on each row
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sC + (16 * gw + (lane & 7) + (mi & 1) * 8) * NS + k0 +
                         (mi >> 1) * 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= npairs) break;
        const int off = (16 * q + (mi >> 1) * 8 + (lane & 7)) * NS + k0 +
                        (mi & 1) * 8;
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, sHh + off);
        ldmatrix_x4(bl, sHl + off);
        mma_bf16_16816(acc[2 * q], a, bh[0], bh[1]);
        mma_bf16_16816(acc[2 * q], a, bl[0], bl[1]);
        mma_bf16_16816(acc[2 * q + 1], a, bh[2], bh[3]);
        mma_bf16_16816(acc[2 * q + 1], a, bl[2], bl[3]);
      }
    }
    const int r0 = i0 + 16 * gw + g, r1 = r0 + 8;    // rows of the chunk
    const float cum0 = sCum[r0], cum1 = sCum[r1];
    {
      const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        acc[t][0] *= e0;
        acc[t][1] *= e0;
        acc[t][2] *= e1;
        acc[t][3] *= e1;
      }
    }
    const int next = next_tile(nblk, group, ib);
    barrier();                                // the group's readers of sC
    if (next >= 0) {
      copy_rows<GT>(sC, NS, cc + static_cast<size_t>(next) * ROWS * N, N,
                     min(ROWS, valid - next * ROWS), N, vec_bc, gtid);
      hopper::cp_async_commit();
    }

    // intra-chunk term over the column tiles j <= i
    const bf16* sX = sX0;
    for (int jb = 0; jb <= ib; ++jb) {
      const int j0 = jb * ROWS;
      // this warp's C·B^T values of the tile, in the A-fragment layout
      float2 cv[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* c0 = cbc + static_cast<size_t>(r0) * Qp + j0 + 16 * kk +
                          2 * t4;
        const float* c1 = c0 + 8 * static_cast<size_t>(Qp);
        cv[kk][0] = *reinterpret_cast<const float2*>(c0);
        cv[kk][1] = *reinterpret_cast<const float2*>(c1);
        cv[kk][2] = *reinterpret_cast<const float2*>(c0 + 8);
        cv[kk][3] = *reinterpret_cast<const float2*>(c1 + 8);
      }
      // in flight while this tile runs: the next x tile, or after the
      // last one the first x tile of the group's next row tile
      const int ahead = jb < ib ? j0 + ROWS : next >= 0 ? 0 : -1;
      if (ahead >= 0) {
        copy_rows<GT>(sX0 + (buf ^ 1) * ROWS * XS, XS, xc + ahead * x_row,
                       x_row, min(ROWS, valid - ahead), P, vec_x, gtid);
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      barrier();                              // this x tile has landed
      sX = sX0 + buf * ROWS * XS;
      const bool diag = jb == ib;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // above the diagonal, or past the chunk's last step: zeros
        if ((diag && kk > gw) || j0 + 16 * kk >= valid) break;
        const int col = j0 + 16 * kk + 2 * t4;
        // columns col, col + 1, col + 8, col + 9: their cum_a and dt
        const float2 cja = *reinterpret_cast<const float2*>(sCum + col);
        const float2 cjb = *reinterpret_cast<const float2*>(sCum + col + 8);
        const float2 dja = *reinterpret_cast<const float2*>(sDt + col);
        const float2 djb = *reinterpret_cast<const float2*>(sDt + col + 8);
        // the score of (row r, column j): C_r·B_j exp(cum_r - cum_j) dt_j,
        // the decay formed only where j <= r (off the diagonal tile, always)
        auto score = [&](float cbv, int r, float cum_r, int j, float cum_j,
                         float dt_j) {
          return (!diag || j <= r) ? cbv * (expf(cum_r - cum_j) * dt_j) : 0.f;
        };
        uint32_t ah[4], al[4];
        split2(score(cv[kk][0].x, r0, cum0, col, cja.x, dja.x),
               score(cv[kk][0].y, r0, cum0, col + 1, cja.y, dja.y), ah[0],
               al[0]);
        split2(score(cv[kk][1].x, r1, cum1, col, cja.x, dja.x),
               score(cv[kk][1].y, r1, cum1, col + 1, cja.y, dja.y), ah[1],
               al[1]);
        split2(score(cv[kk][2].x, r0, cum0, col + 8, cjb.x, djb.x),
               score(cv[kk][2].y, r0, cum0, col + 9, cjb.y, djb.y), ah[2],
               al[2]);
        split2(score(cv[kk][3].x, r1, cum1, col + 8, cjb.x, djb.x),
               score(cv[kk][3].y, r1, cum1, col + 9, cjb.y, djb.y), ah[3],
               al[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= npairs) break;
          uint32_t bx[4];                     // x: rows j, columns p
          ldmatrix_x4_trans(bx, sX + (16 * kk + (mi & 1) * 8 + (lane & 7)) *
                                         XS + 16 * q + (mi >> 1) * 8);
          mma_bf16_16816(acc[2 * q], ah, bx[0], bx[1]);
          mma_bf16_16816(acc[2 * q], al, bx[0], bx[1]);
          mma_bf16_16816(acc[2 * q + 1], ah, bx[2], bx[3]);
          mma_bf16_16816(acc[2 * q + 1], al, bx[2], bx[3]);
        }
      }
      buf ^= 1;
      if (jb < ib) barrier();                 // readers of this buffer, before
                                              // the tile after next fills it
    }

    // y = acc (+ D·x; sX holds this row tile's x rows)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= valid) continue;
      float* yr = y + (static_cast<size_t>(b) * S + s0 + r) * x_row +
                  static_cast<size_t>(h) * P;
      const bf16* xr = sX + (r - i0) * XS;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int p = 8 * t + 2 * t4;
        if (p >= P) break;
        float v0 = acc[t][2 * half], v1 = acc[t][2 * half + 1];
        if (D != nullptr) {
          v0 += d_h * __bfloat162float(xr[p]);
          v1 += d_h * __bfloat162float(xr[p + 1]);
        }
        if ((P & 1) == 0) {
          *reinterpret_cast<float2*>(yr + p) = make_float2(v0, v1);
        } else {
          yr[p] = v0;
          if (p + 1 < P) yr[p + 1] = v1;
        }
      }
    }
    ib = next;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename Kernel>
int set_smem(Kernel* kernel, size_t bytes) {
  return launch_once::allow_smem(reinterpret_cast<const void*>(kernel), bytes);
}

int launch(const bf16* x, const float* dt, const float* A, const bf16* Bm,
           const bf16* Cm, const float* D, const float* h0, float* y,
           float* h_final, float* ws_state, float* ws_cb, float* ws_cum,
           int Bsz, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const int Qp = (Q + ROWS - 1) / ROWS * ROWS, nblk = Qp / ROWS;
  const int NC = (S + Q - 1) / Q;
  if (NC > 65535 || Bsz > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_x = P % 8 == 0 && aligned16(x);
  const int vec_bc = N % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  int err;
  if (NC > 0) {
    ssd_cb_kernel<<<dim3(nblk * (nblk + 1) / 2, NC, Bsz), CB_THREADS, 0,
                    stream>>>(Bm, Cm, ws_cb, S, N, Q, Qp, NC, vec_bc);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    if ((err = set_smem(ssd_state_kernel,
                        state_smem(Qp))))
      return err;
    ssd_state_kernel<<<dim3(H, NC, Bsz), STATE_THREADS, state_smem(Qp),
                       stream>>>(x, dt, A, Bm, ws_state, ws_cum, S, H, P, N,
                                 Q, Qp, NC, vec_x, vec_bc);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  ssd_pass_kernel<<<dim3((P * N + PASS_THREADS - 1) / PASS_THREADS, H, Bsz),
                    PASS_THREADS, 0, stream>>>(ws_state, ws_cum, h0, h_final,
                                               H, P * N, Q, Qp, NC);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if (NC > 0) {
    if ((err = set_smem(ssd_scan_kernel,
                        scan_smem(Qp))))
      return err;
    ssd_scan_kernel<<<dim3(H, NC, Bsz), SCAN_THREADS, scan_smem(Qp),
                      stream>>>(x, dt, Cm, D, ws_cb, ws_state, ws_cum, y, S,
                                H, P, N, Q, Qp, NC, vec_x, vec_bc);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// stages; x, B and C alike).  x (B,S,H,P), dt (B,S,H), B and C (B,S,N),
// y (B,S,H,P) and h_final (B,H,P,N), all contiguous; A (H,); D (H,) or
// null (no D-term); h0 (B,H,P,N) or null (zeros).  1 <= P <= 64, 1 <= N <=
// 128, 1 <= Q (the chunk, min(chunk, S)).  The bf16 route's f32 workspace,
// 16-byte aligned: ws_state B*NC*H*P*N (chunk states, then h_prev), ws_cb
// B*NC*Qp*Qp (C·B^T) and ws_cum B*NC*H*Qp (cum_a) floats, NC = ceil(S/Q),
// Qp = Q rounded up to 64; the f32 route takes nulls.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D,
                        const void* h0, void* y, void* h_final, void* ws_state,
                        void* ws_cb, void* ws_cum, int Bsz, int S, int H,
                        int P, int N, int Q, void* stream) {
  if (P < 1 || P > MAX_P || N < 1 || N > MAX_N || Q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bsz == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_final);
  switch (dtype) {
    case 0:
      return simt::launch_fma(static_cast<const float*>(x), dtf, Af,
                             static_cast<const float*>(Bm),
                             static_cast<const float*>(Cm), Df, h0f, yf, hf,
                             Bsz, S, H, P, N, Q, s);
    case 1:
      if (ws_state == nullptr || ws_cb == nullptr || ws_cum == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return tc::launch(static_cast<const tc::bf16*>(x), dtf, Af,
                        static_cast<const tc::bf16*>(Bm),
                        static_cast<const tc::bf16*>(Cm), Df, h0f, yf, hf,
                        static_cast<float*>(ws_state),
                        static_cast<float*>(ws_cb),
                        static_cast<float*>(ws_cum), Bsz, S, H, P, N, Q, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
