// Mamba-2 SSD chunked scan (forward) for sm_90a, in float32 on the CUDA
// cores.
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/ssd_chunk.py::ssd_chunked_tpu (body _ssd_body).
//
// Contract: x (B, L, H, dh), B and C (B, L, N) shared by all heads, float32
// or bfloat16; dt (B, L, H), A (H,), D (H,) float32; L % Q == 0.  Per
// (batch, head), with a = dt * A and the (dh, N) state s starting at 0, for
// each chunk of Q rows, cum = inclusive cumsum of a over the chunk:
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) (s C_i) + D x_i
//   s   = exp(cum_Q) s + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
// y (B, L, H, dh) in x's type, the final state (B, H, dh, N) in float32.
// D x is added inside, as the Pallas body does.
//
// Design, correctness first.  One block of 256 threads per (head, batch):
// grid (H, B).  The state stays in shared memory through the chunk loop,
// as in the Pallas body.  What differs from it:
//   * The (Q, Q) decay-weighted scores do not fit: at Q = 256 they are
//     256 KB in float32, more than a block's 227 KB.  The chunk is walked in
//     64-row strips i and, inside a strip, 64-row key tiles j <= i (tiles
//     above the diagonal are skipped): the 64 x 64 product C_i B_j^T is
//     weighted by exp(cum_i - cum_j), computed on the fly from the chunk's
//     cumsum (a warp scan), and multiplied into dt_j x_j.
//   * Above the diagonal (i < j) cum_i - cum_j > 0 and its exp can
//     overflow; the weight is chosen as 0 there before any exp is taken, so
//     no inf reaches a product (the reference's where).
//   * exp(cum) underflows to 0 within a chunk with the default init (A =
//     -1, dt ~ 0.7); both this kernel and the plain version do so alike.
// Products are float32 FMA tile products (tile_fma.cuh).  dh is padded to
// 64 and N to NP in {64, 128} with zeros (dh <= 64, N <= 128).
//
// Bound on this card: operations.  Per (batch, head, chunk) the function
// does 2 Q^2 N (C B^T, which all heads share; counted once per head here)
// + Q^2 dh (the causal half of the weighted product) + 2 Q N dh (the
// state's contribution) + 2 Q dh N (the state update) flops, against
// reading x, dt, B, C once and writing y once.  Occupancy: B*H blocks (224
// for Zamba2-7B at B = 2, 48 for Mamba2-130M) fill fewer than the 132 SMs
// twice over; a later design splits the chunk's state-free work over more
// blocks and passes states between them, and computes C B^T once per batch.
//
// Host entry point: plain C interface (ctypes), launches on the given
// stream, allocates nothing, returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_fma.cuh"

namespace {

constexpr int kDH = 64;                           // head dim, padded
constexpr int kLdX = kDH;
constexpr int kLdP = row_stride(kTileRows);

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [row0, row0 + 64) of the chunk (global row base + row) of a (B, L, N)
// tensor into shared memory (64 x NP, float32, zero past the chunk and N).
template <int NP, typename T>
__device__ __forceinline__ void stage_bc(float* dst, int ld, const T* src,
                                         int b, int L, int base, int row0,
                                         int Q, int N) {
  for (int e = threadIdx.x; e < kTileRows * NP; e += kTileThreads) {
    const int r = e / NP;
    const int n = e - r * NP;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < Q && n < N)
      v = widen(src[(static_cast<size_t>(b) * L + base + row) * N + n]);
    dst[r * ld + n] = v;
  }
}

template <int NP, typename T>
__global__ void __launch_bounds__(kTileThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ D,
                 T* __restrict__ y, float* __restrict__ state, int L, int H,
                 int dh, int N, int Q) {
  constexpr int kLdN = row_stride(NP);
  constexpr int kNJ = NP / 16;
  extern __shared__ __align__(16) float smem[];
  float* s_s = smem;                        // state, dh x NP
  float* c_s = s_s + kTileRows * kLdN;      // C strip, 64 x NP
  float* b_s = c_s + kTileRows * kLdN;      // B tile, 64 x NP
  float* x_s = b_s + kTileRows * kLdN;      // scaled x tile, 64 x 64
  float* p_s = x_s + kTileRows * kLdX;      // weighted scores, 64 x 64
  float* cum_s = p_s + kTileRows * kLdP;    // Q
  float* dt_s = cum_s + Q;                  // Q

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int r0 = (threadIdx.x >> 4) * 4;
  const float Ah = A[h];
  const float Dh = D[h];
  const size_t xrow = static_cast<size_t>(H) * dh;   // x / y row stride
  const T* xb = x + static_cast<size_t>(b) * L * xrow + static_cast<size_t>(h) * dh;
  T* yb = y + static_cast<size_t>(b) * L * xrow + static_cast<size_t>(h) * dh;

  for (int e = threadIdx.x; e < kTileRows * kLdN; e += kTileThreads)
    s_s[e] = 0.0f;

  // x tile rows [row0, row0 + 64) of the chunk, each row scaled by w(row).
  auto stage_x = [&](int base, int row0, auto w) {
    for (int e = threadIdx.x; e < kTileRows * kDH; e += kTileThreads) {
      const int r = e / kDH;
      const int d = e - r * kDH;
      const int row = row0 + r;
      float v = 0.0f;
      if (row < Q && d < dh) v = w(row) * widen(xb[(base + row) * xrow + d]);
      x_s[r * kLdX + d] = v;
    }
  };

  for (int base = 0; base < L; base += Q) {
    __syncthreads();        // the previous chunk is done with cum_s, dt_s
    for (int i = threadIdx.x; i < Q; i += kTileThreads)
      dt_s[i] = dt[(static_cast<size_t>(b) * L + base + i) * H + h];
    __syncthreads();
    if (threadIdx.x < 32) {  // inclusive cumsum of a = dt * A: a warp scan
      const int lane = threadIdx.x;
      const int per = (Q + 31) / 32;
      const int lo = min(lane * per, Q);
      const int hi = min(lo + per, Q);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) run += dt_s[i] * Ah;
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float c = incl - run;
      for (int i = lo; i < hi; ++i) {
        c += dt_s[i] * Ah;
        cum_s[i] = c;
      }
    }
    __syncthreads();
    const float total = cum_s[Q - 1];

    for (int i0 = 0; i0 < Q; i0 += kTileRows) {
      __syncthreads();      // the previous strip is done with c_s
      stage_bc<NP>(c_s, kLdN, Cm, b, L, base, i0, Q, N);
      float acc[4][4] = {};
      for (int j0 = 0; j0 <= i0; j0 += kTileRows) {
        __syncthreads();    // the previous tile is done with b_s, x_s, p_s
        stage_bc<NP>(b_s, kLdN, Bm, b, L, base, j0, Q, N);
        stage_x(base, j0, [&](int row) { return dt_s[row]; });
        __syncthreads();
        float sc[4][4] = {};
        fma_abt<4>(sc, c_s, kLdN, b_s, kLdN, NP, r0, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ri = i0 + r0 + i;
            const int cj = j0 + tx + 16 * j;
            const float w = (ri < Q && cj < Q && ri >= cj)
                                ? expf(cum_s[ri] - cum_s[cj]) : 0.0f;
            p_s[(r0 + i) * kLdP + tx + 16 * j] = sc[i][j] * w;
          }
        __syncthreads();
        fma_ab<4>(acc, p_s, kLdP, x_s, kLdX, kTileRows, r0, tx);
      }
      // the carried-in state's contribution, and D x
      float cs[4][4] = {};
      fma_abt<4>(cs, c_s, kLdN, s_s, kLdN, NP, r0, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = i0 + r0 + i;
        if (ri >= Q) continue;
        const float decay_in = expf(cum_s[ri]);
        const size_t at = (base + ri) * xrow;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = tx + 16 * j;
          if (d >= dh) continue;
          const float v = acc[i][j] + decay_in * cs[i][j]
                          + Dh * widen(xb[at + d]);
          narrow(yb + at + d, v);
        }
      }
    }

    // state update: s = exp(total) s + sum_j (exp(total - cum_j) dt_j x_j) B_j^T
    float ds[4][kNJ] = {};
    for (int j0 = 0; j0 < Q; j0 += kTileRows) {
      __syncthreads();
      stage_bc<NP>(b_s, kLdN, Bm, b, L, base, j0, Q, N);
      stage_x(base, j0,
              [&](int row) { return expf(total - cum_s[row]) * dt_s[row]; });
      __syncthreads();
      fma_atb<kNJ>(ds, x_s, kLdX, b_s, kLdN, kTileRows, r0, tx);
    }
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        float* at = s_s + (r0 + i) * kLdN + tx + 16 * j;
        *at = decay * *at + ds[i][j];
      }
  }

  __syncthreads();
  float* sb = state + (static_cast<size_t>(b) * H + h) * dh * N;
  for (int e = threadIdx.x; e < dh * N; e += kTileThreads) {
    const int d = e / N;
    sb[e] = s_s[d * kLdN + (e - d * N)];
  }
}

size_t smem_bytes(int np, int Q) {
  const int ld_n = np == 64 ? row_stride(64) : row_stride(128);
  return sizeof(float) * (3 * kTileRows * ld_n + kTileRows * kLdX
                          + kTileRows * kLdP + 2 * static_cast<size_t>(Q));
}

template <int NP, typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D, void* y,
                   void* state, int B, int L, int H, int dh, int N, int Q,
                   cudaStream_t stream) {
  auto kernel = ssd_chunk_kernel<NP, T>;
  const size_t smem = smem_bytes(NP, Q);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (B > 0 && H > 0 && L > 0) {
    kernel<<<dim3(H, B), kTileThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<const float*>(D),
        static_cast<T*>(y), static_cast<float*>(state), L, H, dh, N, Q);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* D, void* y,
                     void* state, int B, int L, int H, int dh, int N, int Q,
                     cudaStream_t stream) {
  if (N <= 64)
    return launch<64, T>(x, dt, A, Bm, Cm, D, y, state, B, L, H, dh, N, Q,
                         stream);
  return launch<128, T>(x, dt, A, Bm, Cm, D, y, state, B, L, H, dh, N, Q,
                        stream);
}

}  // namespace

// y (B, L, H, dh) and the final state (B, H, dh, N) of the SSD scan; bf16
// != 0 marks bfloat16 x, B, C and y (float32 otherwise).  Takes dh <= 64,
// N <= 128, L % Q == 0.  Returns a cudaError_t; cudaErrorInvalidValue for
// shapes it does not take.
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* D,
                             void* y, void* state, int B, int L, int H,
                             int dh, int N, int Q, int bf16, void* stream) {
  if (dh < 1 || dh > kDH || N < 1 || N > 128 || Q < 1 || L % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch_n<__nv_bfloat16>(
        x, dt, A, Bm, Cm, D, y, state, B, L, H, dh, N, Q, s));
  return static_cast<int>(launch_n<float>(x, dt, A, Bm, Cm, D, y, state, B,
                                          L, H, dh, N, Q, s));
}
