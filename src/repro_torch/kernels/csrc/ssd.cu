// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces the TPU kernel kernels/ssd/kernel.py ssd_fwd (body _kernel) of the
// JAX package, with the two operands the JAX model's ssd_chunked adds: an
// optional initial state h0 and f32 outputs.  Per (batch row b, head h), over
// chunks of Q steps taken in order:
//   cum_a  = prefix sum of dt·A over the chunk                         (f32)
//   y_i    = sum_{j <= i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j         intra
//          + exp(cum_i) C_i·h_prev^T                                   inter
//          + D·x_i                                       (only when D given)
//   h      = exp(cum_end) h_prev + x^T (B ⊙ exp(cum_end - cum) ⊙ dt)    carry
// B and C (B,S,N) are shared by every head (n_groups = 1); x (B,S,H,P) and
// B, C are float32 or bfloat16 (one dtype), dt (B,S,H) and A (H,) float32.
// Every product and sum is f32 (bf16 inputs are widened on load, as the TPU
// kernel widens them); y (B,S,H,P) and h_final (B,H,P,N) are written as f32,
// so a bf16 model rounds y once, after its own D-term, as ssd_chunked's
// caller does.  A ragged last chunk reads dt = 0 and zeros past S, which
// leaves the state unchanged; its rows past S are not written.
//
// What bounds it: bytes.  With C·B^T formed once per (batch, chunk) and only
// the causal half of each chunk's (Q, Q) products counted, a mamba2-1.3b
// layer at S = 4500 (H = 64, P = 64, N = 128, Q = 256) needs ~1.5e10 flops
// against ~1.2e8 bytes (x in, y out in f32, B, C, dt, h_final): about 120
// flops per byte, under the card's ~300 bf16 flop/byte balance point.
//
// Design (simple and correct first):
// - one CTA of 256 threads per (head, batch row) walks the chunks in order,
//   the TPU's sequential chunk axis; the (P, N) f32 state stays in shared
//   memory across chunks (64 x 129 floats at most);
// - the chunk is cut into 64-row tiles; for each row tile i the C tile stays
//   in shared memory while the B and x tiles j <= i stream through: the
//   64 x 64 score tile C_i·B_j^T (4 x 4 per thread in registers, a 16 x 16
//   thread grid) is weighted by exp(cum_i - cum_j)·dt_j only where j <= i —
//   above the diagonal the exponent is positive and may overflow, and
//   inf·0 would give NaN — then multiplied into the 64 x P output tile;
// - the state update runs after every row tile of the chunk has read h_prev;
//   each thread owns 4 x 8 elements of the (P, N) state;
// - cum_a is an inclusive Hillis-Steele scan in shared memory.
// C·B^T is recomputed per head (the TPU kernel does the same), and only
// B x H CTAs run (64 for one mamba2-1.3b sequence on 132 SMs): splitting the
// chunks across CTAs with a separate pass over the chunk states, and the
// tensor cores, are work for later changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;            // rows of a chunk tile, columns of a score tile
constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int MAX_P = 64;           // head_dim: 4 columns per thread
constexpr int MAX_N = 128;          // state: 8 columns per thread in the carry
constexpr int RI = TILE / TY;       // rows per thread
constexpr int CJ = TILE / TX;       // score / output columns per thread
constexpr int NJ = MAX_N / TX;      // state columns per thread
constexpr int SP = TILE + 1;        // padded stride of the score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Copies rows 0..rows-1 (rows <= TILE) of a (.., cols) slice whose rows are
// row_stride elements apart into dst (row stride dst_stride) as f32, and
// zeros into rows rows..TILE-1.  Columns at or past cols are not touched.
// Each thread keeps LU loads in flight before it stores.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int dst_stride,
                                          const T* __restrict__ src,
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
      v[u] = (e < n && r < rows) ? to_f32(src[r * row_stride + c]) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
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
  const T* xb = x + static_cast<size_t>(b) * S * x_row + static_cast<size_t>(h) * P;
  const T* Bb = Bm + static_cast<size_t>(b) * S * N;
  const T* Cb = Cm + static_cast<size_t>(b) * S * N;
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

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, const float* h0, float* y,
           float* h_final, int Bsz, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  const int Qp = (Q + TILE - 1) / TILE * TILE;
  const size_t smem = smem_floats(N, Qp) * sizeof(float);
  auto kern = ssd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(H, Bsz), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, h0, y, h_final, S, H, P, N, Q, Qp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C alike).  x (B,S,H,P), dt
// (B,S,H), B and C (B,S,N), y (B,S,H,P) and h_final (B,H,P,N), all
// contiguous; A (H,); D (H,) or null (no D-term); h0 (B,H,P,N) or null
// (zeros).  1 <= P <= 64, 1 <= N <= 128, 1 <= Q (the chunk, min(chunk, S)).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D,
                        const void* h0, void* y, void* h_final, int Bsz, int S,
                        int H, int P, int N, int Q, void* stream) {
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
      return launch<float>(x, dtf, Af, Bm, Cm, Df, h0f, yf, hf, Bsz, S, H, P, N,
                           Q, s);
    case 1:
      return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, h0f, yf, hf, Bsz, S,
                                   H, P, N, Q, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
