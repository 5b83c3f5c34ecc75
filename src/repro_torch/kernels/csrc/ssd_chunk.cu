// Mamba-2 SSD chunked scan (forward) for sm_90a: chunk-parallel, its
// products on the tensor cores (wgmma and mma.sync, TF32) at float32
// accuracy.
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
//
// Bound on this card: operations.  Per (batch, chunk) the function needs
// 2 N Q(Q+1)/2 flops for C B^T, and per (batch, head, chunk) 2 dh Q(Q+1)/2
// for the weighted product, 2 Q N dh for the carried-in state's
// contribution, 2 Q dh N for the state update, against reading x, dt, B, C
// and writing y once: at Zamba2-7B's prefill 15.2 GFLOP over 242 MB.  At
// float32 accuracy on the tensor cores (three TF32 products at 495 TFLOP/s)
// that is 0.092 ms, on the CUDA cores (67 TFLOP/s) 0.227 ms.  The Pallas
// body's one program per (batch, head) walking the chunks, carried over,
// gave 224 blocks at Zamba2-7B's shape and 48 at Mamba2-130M's, recomputed
// C B^T for every head and ran on the CUDA cores: 16% of the float32 bound.
//
// Design.  The recurrence's only serial part is the (dh, N) state; the
// rest of a chunk depends on the state only through one product.  So the
// chunk loop is split over blocks, in four launches:
//   (a) ssd_chunk_cbt: G = C B^T once per (batch, chunk), its 64 x 64 tiles
//       on and below the diagonal, into a workspace (B, nc, QP, QP), QP = Q
//       rounded up to 64; every head reads it from L2.
//   (b) ssd_chunk_states: per (batch, head, chunk) and 64 state dims, cum
//       (a warp scan), kept with dt in a workspace (B, H, nc, QP, 2), and
//       the chunk's own state U = sum_j exp(total - cum_j) dt_j x_j B_j^T,
//       transposed, into a workspace (B, H, nc, NP, DHP), DHP = dh rounded
//       up to 16, NP = N to 8.
//   (c) ssd_chunk_pass: per (batch, head) and 4 state elements, in chunk
//       order, s = exp(total_c) s + U_c, each U_c replaced by the state the
//       chunk carries in; the last s is the final state.
//   (d) ssd_chunk_scan: per (batch, head, chunk, 64-row strip),
//       y = exp(cum_i) (C s_in^T) + (G . W) x + D x, with W_ij =
//       exp(cum_i - cum_j) dt_j below the diagonal: ceil(N / 64) state
//       tiles, then the key tiles j <= the strip.  A chunk's strips are
//       neighbours in the grid (they share x, C and G in L2), heaviest
//       first.
//   Zamba2-7B's prefill (B = 2, H = 112, Q = 256, nc = 8) gives 7,168 scan
//   blocks, Mamba2-130M's (H = 24) 1,536.
//   * Products.  (b) and (d) run wgmma m64n64k8 TF32 on a warpgroup (a
//     block), (a) mma.sync m16n8k8, each with the three-term split of
//     tf32_mma.cuh (a_hi b_hi + a_hi b_lo + a_lo b_hi), float32 sums.  A
//     warp's A fragments are built in registers (16 rows; fragment column t
//     is index 2t of the k-step, column t + 4 index 2t + 1, so a thread's
//     values are two neighbours of a row); B, a 64 x 64 tile staged raw, is
//     split once by the block into hi and lo planes laid out as wgmma's
//     core matrices (split_b) with the same index order.  The split is
//     done in integer operations (split), cheaper than the conversion
//     instruction.
//   * The decay weight is computed in registers from cum, chosen as 0 above
//     the diagonal before any exp: there cum_i - cum_j > 0 and its exp can
//     overflow (cum over a 256-row chunk reaches about -180 with the
//     default init).  exp(cum_i - cum_j) is never formed as a product of
//     exp(cum_i) and exp(-cum_j).  The weights take __expf (ex2.approx of
//     x log2 e; within 2 + 1.2 |x| ulp, x <= 0, results below 2**-126 flush
//     to 0); exp(cum_i) and exp(total) take expf.  exp(cum) underflows to 0
//     within a chunk, here and in the plain version alike.
//   * Staging: tiles go to shared memory by 16-byte cp.async where rows are
//     16-byte multiples and aligned (plain copies otherwise); bfloat16 is
//     widened as it is read.  (d) keeps two raw B tiles in flight and reads
//     each warp's A values (G, or C) from L2 a tile ahead, while the
//     products run.
//   Padding: rows past Q, head dims past dh and state dims past N are zero
//   (zero-filled tiles, zero weights), never stored to y or the state.
//   The variants measured on the way, and the ablations of this design,
//   are kernels/tune_ssd.py's.
//
// Host entry point: plain C interface (ctypes), launches on the given
// stream, allocates nothing (the caller passes the three workspaces),
// returns the first failing launch's error (cudaGetLastError()).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kTile = 64;       // rows of a strip, keys of a key tile
constexpr int kThreads = 128;   // 4 warps of 16 rows: one warpgroup
constexpr int kDH = 64;         // largest head dim
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 8;  // chunks whose loads (c) issues together

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// Row stride (elements) of a staged tile of `cols` columns (64 or 128)
// whose fragments are read two rows 2t and 2t + 1 apart: 4 mod 16 words.
template <typename T>
__host__ __device__ constexpr int krow_ld(int cols) {
  return cols + 16 / static_cast<int>(sizeof(T));
}
// ... read as pairs of neighbouring elements of rows g: 8 mod 32 words
// (float), 4 mod 32 (bfloat16).
__host__ __device__ constexpr int pair_ld(int cols) { return cols + 8; }

// Shared tiles of (b) and (d): a raw tile as staged (64 x 64, float or T,
// read as k-rows), and wgmma's B operand split into TF32 hi and lo planes
// (split_b).
constexpr int kRawBytes = kTile * krow_ld<float>(kDH) * 4;
constexpr int kPlane = kTile * kDH;                 // words of one plane

// split_tf32 of tf32_mma.cuh in integer operations: rounding to nearest,
// ties away from zero, adds half a TF32 unit to the magnitude's bits (a
// carry into the exponent is the right rounding) and clears the low 13.
// Equal to split_tf32 for every float but a NaN, whose product is NaN
// either way; the conversion instruction runs at a fraction of the integer
// rate (kernels/tune_ssd.py, "cvt split").
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// One m16n8k8 step at float32 accuracy: d += A . B with A split into
// (ah, al) and B = (b0, b1) split here.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, ah, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, al, h0, h1);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
}

// Rows [0, 64) and columns [0, COLS) of a tile into shared memory (row
// stride LD), row r from src + r * stride, zero past `rows` and `cols`.
// vec: 16-byte cp.async (cols * sizeof(T) and stride * sizeof(T) multiples
// of 16, src 16-byte aligned), else plain copies.
template <typename T, int COLS, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t stride,
                                      int rows, int cols, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kChunks = COLS / kPer;
    for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int col = (e - r * kChunks) * kPer;
      const bool ok = r < rows && col < cols;
      cp_async<16>(dst + r * LD + col, ok ? src + r * stride + col : src,
                   ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * COLS; e += kThreads) {
      const int r = e / COLS;
      const int col = e - r * COLS;
      dst[r * LD + col] = r < rows && col < cols ? src[r * stride + col]
                                                 : zero<T>();
    }
  }
}

// Two neighbouring elements of a row, widened.
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// y[d], y[d + 1] of a row; the second only where d + 1 < dh.
__device__ __forceinline__ void store_pair(float* p, float v0, float v1,
                                           bool both) {
  if (both && reinterpret_cast<uintptr_t>(p) % 8 == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (both) p[1] = v1;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1, bool both) {
  if (both && reinterpret_cast<uintptr_t>(p) % 4 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (both) p[1] = __float2bfloat16_rn(v1);
  }
}

// Two neighbouring elements of a row in global memory, widened; 0 past
// `cols`.  vec: the row's pairs are aligned (plain loads otherwise).
template <typename T>
__device__ __forceinline__ float2 load_pair(const T* row, int col, int cols,
                                            bool vec) {
  if (vec && col + 1 < cols) return pair(row + col);
  return make_float2(col < cols ? widen(row[col]) : 0.0f,
                     col + 1 < cols ? widen(row[col + 1]) : 0.0f);
}

// d[0..8) (the m64n64 accumulator, columns 8c .. 8c + 7 in d[c]) += A
// (m64k8, this warp's 16 rows in registers, the m16n8k8 A fragment) . B
// (k8n64 at b).
__device__ __forceinline__ void wgmma64(float (&d)[8][4],
                                        const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A raw tile (row k, column n, row stride LD), each row scaled by
// scale[k] where kScaled, split into hi and lo planes, each wgmma's B
// operand (k8n64 a k-step): k-step j (rows 8j .. 8j + 7) is 64 x 8 words
// at 512j; columns 8c .. 8c + 7 form core matrices at 64c words (kSBO),
// row 8j + kk sits at column kk >> 1 of the half kk & 1 (kLBO), so column
// t of a k-step holds row 2t and column t + 4 row 2t + 1 (the A
// fragments' order).  A thread splits 4 rows of one column: one 16-byte
// store a plane.
template <typename TB, int LD, bool kScaled>
__device__ __forceinline__ void split_b(uint32_t* hi, uint32_t* lo,
                                        const TB* raw, const float* scale) {
  for (int e = threadIdx.x; e < kTile * kDH / 4; e += kThreads) {
    const int n = e % kDH;
    const int jh = e / kDH;                          // 2j + half
    const int k = 8 * (jh >> 1) + (jh & 1);
    float v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      v[m] = widen(raw[(k + 2 * m) * LD + n]);
      if constexpr (kScaled) v[m] *= scale[k + 2 * m];
    }
    uint4 hv, lv;
    split(v[0], hv.x, lv.x);
    split(v[1], hv.y, lv.y);
    split(v[2], hv.z, lv.z);
    split(v[3], hv.w, lv.w);
    const int off = (jh >> 1) * 512 + (n >> 3) * 64 + (jh & 1) * 32
                    + (n & 7) * 4;
    *reinterpret_cast<uint4*>(hi + off) = hv;
    *reinterpret_cast<uint4*>(lo + off) = lv;
  }
}

// acc += A . B over one 64-deep tile on the block's warpgroup: A this
// warp's fragments a[kk] (rows g, g + 8; k = 8kk + 2t, 8kk + 2t + 1), split
// here; B the planes.  Three TF32 terms a k-step.  then(a) runs once a is
// split, while the products are in flight (a is free to take the next
// tile's values); returns when the products are done.
template <typename Then>
__device__ __forceinline__ void wgmma_tile(float (&acc)[8][4],
                                           float (&a)[8][4],
                                           const uint32_t* hi,
                                           const uint32_t* lo, Then then) {
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) split4(a[kk], ah[kk], al[kk]);
  reg_fence(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma64(acc, ah[kk], wgmma_desc(hi + 512 * kk));
    wgmma64(acc, ah[kk], wgmma_desc(lo + 512 * kk));
    wgmma64(acc, al[kk], wgmma_desc(hi + 512 * kk));
  }
  wg_commit();
  then(a);
  wg_wait();
  reg_fence(acc);
}

// (a) The 64 x 64 tile (it, jt), jt <= it, of G = C B^T of one (batch,
// chunk): grid (tile pairs, nc, B).
template <typename T, int NPT>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_cbt(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cbt, int L, int N, int Q, int QP,
              bool vec) {
  constexpr int LD = pair_ld(NPT);
  extern __shared__ __align__(16) unsigned char smem[];
  T* c_s = reinterpret_cast<T*>(smem);
  T* b_s = c_s + kTile * LD;

  const int pair = blockIdx.x;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int i0 = it * kTile, j0 = jt * kTile;
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
  stage<T, NPT, LD>(c_s, Cm + (row0 + i0) * N, N, Q - i0, N, vec);
  stage<T, NPT, LD>(b_s, Bm + (row0 + j0) * N, N, Q - j0, N, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  float acc[8][4] = {};
  const T* ca = c_s + (16 * warp + g) * LD + 2 * t;
  for (int k0 = 0; k0 < N; k0 += 8) {
    const float a[4] = {widen(ca[k0]), widen(ca[8 * LD + k0]),
                        widen(ca[k0 + 1]), widen(ca[8 * LD + k0 + 1])};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const T* bb = b_s + (nt * 8 + g) * LD + k0 + 2 * t;
      mma3(acc[nt], ah, al, widen(bb[0]), widen(bb[1]));
    }
  }
  float* gr = cbt + ((static_cast<size_t>(b) * nc + c) * QP + i0 + 16 * warp
                     + g) * QP + j0 + 2 * t;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(gr + nt * 8) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(gr + 8 * QP + nt * 8) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// (b) Per (batch, head, chunk) and 64 state dims n: cum and dt into cd (by
// the first block of the chunk), and rows [64 nb, 64 nb + 64) of the
// chunk's own state, transposed, U^T = sum_j B_j (w_j x_j)^T with w_j =
// exp(total - cum_j) dt_j: grid (nc * NB, H, B), NB = ceil(N / 64).  A is
// B's tile read as k-rows, B the x tile scaled by w and split into planes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_states(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ cd, int L,
                 int H, int dh, int N, int Q, int QP, int DHP, int NP,
                 bool vec_x, bool vec_b) {
  constexpr int LDX = krow_ld<T>(kDH);
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* hi_s = reinterpret_cast<uint32_t*>(smem);   // x . w hi plane
  uint32_t* lo_s = hi_s + kPlane;                       // x . w lo plane
  T* x_s = reinterpret_cast<T*>(lo_s + kPlane);         // raw x tile
  T* b_s = reinterpret_cast<T*>(smem + 2 * kPlane * 4 + kRawBytes);
  float* w_s = reinterpret_cast<float*>(smem + 2 * kPlane * 4
                                        + 2 * kRawBytes);   // QP
  float* cum_s = w_s + QP;                                  // QP

  const int NB = (N + kTile - 1) / kTile;
  const int c = blockIdx.x / NB, nb = blockIdx.x - c * NB;
  const int h = blockIdx.y, b = blockIdx.z, nc = gridDim.x / NB;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
  const size_t xrow = static_cast<size_t>(H) * dh;
  const T* xc = x + row0 * xrow + static_cast<size_t>(h) * dh;
  const T* bc = Bm + row0 * N + nb * kTile;
  const int n_tiles = QP / kTile;
  auto stage_tile = [&](int kt) {
    stage<T, kDH, LDX>(x_s, xc + kt * kTile * xrow, xrow, Q - kt * kTile, dh,
                       vec_x);
    stage<T, kTile, LDX>(b_s, bc + kt * kTile * N, N, Q - kt * kTile,
                         N - nb * kTile, vec_b);
    cp_async_commit();
  };
  stage_tile(0);

  for (int i = threadIdx.x; i < QP; i += kThreads)
    w_s[i] = i < Q ? dt[(row0 + i) * H + h] : 0.0f;
  __syncthreads();
  if (warp == 0) {          // inclusive cumsum of a = dt * A: a warp scan
    const float Ah = A[h];
    const int lane = threadIdx.x;
    const int per = (Q + 31) / 32;
    const int lo = min(lane * per, Q);
    const int hi = min(lo + per, Q);
    float run = 0.0f;
    for (int i = lo; i < hi; ++i) run += w_s[i] * Ah;
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    float s = incl - run;
    for (int i = lo; i < hi; ++i) {
      s += w_s[i] * Ah;
      cum_s[i] = s;
    }
  }
  __syncthreads();
  const float total = cum_s[Q - 1];
  float2* cdc = reinterpret_cast<float2*>(cd) +
                ((static_cast<size_t>(b) * H + h) * nc + c) * QP;
  for (int i = threadIdx.x; i < QP; i += kThreads) {
    const float cum = i < Q ? cum_s[i] : 0.0f;
    const float dti = w_s[i];
    if (nb == 0) cdc[i] = make_float2(cum, dti);
    w_s[i] = i < Q ? expf(total - cum) * dti : 0.0f;
  }

  float acc[8][4] = {};
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();      // x and B in, the weights written; products done
    // this warp's A values: B_j[n] at n = 16w + g (+ 8), j = 8kk + 2t (+ 1)
    float a[8][4];
    const T* br = b_s + 2 * t * LDX + 16 * warp + g;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const T* r = br + 8 * kk * LDX;
      a[kk][0] = widen(r[0]);
      a[kk][1] = widen(r[8]);
      a[kk][2] = widen(r[LDX]);
      a[kk][3] = widen(r[LDX + 8]);
    }
    split_b<T, LDX, true>(hi_s, lo_s, x_s, w_s + kt * kTile);
    // the planes' stores, made by the generic proxy, visible to wgmma's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();      // the planes are in place; x and B are free
    if (kt + 1 < n_tiles) stage_tile(kt + 1);
    wgmma_tile(acc, a, hi_s, lo_s, [](float (&)[8][4]) {});
  }

  // U^T rows n, columns d
  float* sr = states + ((static_cast<size_t>(b) * H + h) * nc + c) * NP * DHP;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = nb * kTile + 16 * warp + g + 8 * half;
    if (n >= NP) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (d >= DHP) break;
      *reinterpret_cast<float2*>(sr + n * DHP + d) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// (c) State passing: grid (B * H, element blocks), 4 elements a thread.
// Each U_c is replaced by the state chunk c carries in; the final state
// goes to `state`.  The loads of kPassBatch chunks are issued before their
// stores.
__global__ void __launch_bounds__(kPassThreads)
ssd_chunk_pass(float* __restrict__ states, const float* __restrict__ cd,
               float* __restrict__ state, int dh, int N, int Q, int QP,
               int DHP, int NP, int nc) {
  const int bh = blockIdx.x;
  const int e = 4 * (blockIdx.y * kPassThreads + threadIdx.x);
  const int slab = DHP * NP;
  if (e >= slab) return;
  float4* sp = reinterpret_cast<float4*>(
      states + static_cast<size_t>(bh) * nc * slab + e);
  const float* tot = cd + (static_cast<size_t>(bh) * nc * QP + Q - 1) * 2;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float4 u[kPassBatch];
    float decay[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i < nc) {
        u[i] = sp[static_cast<size_t>(c0 + i) * slab / 4];
        decay[i] = tot[static_cast<size_t>(c0 + i) * QP * 2];
      }
    }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i < nc) {
        sp[static_cast<size_t>(c0 + i) * slab / 4] = s;
        const float k = expf(decay[i]);
        s = make_float4(k * s.x + u[i].x, k * s.y + u[i].y,
                        k * s.z + u[i].z, k * s.w + u[i].w);
      }
    }
  }
  const int n = e / DHP, d = e - n * DHP;   // 4 head dims of state n
  const float v[4] = {s.x, s.y, s.z, s.w};
  if (n < N)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d + i < dh)
        state[(static_cast<size_t>(bh) * dh + d + i) * N + n] = v[i];
}

// (d) y for one 64-row strip of one (batch, head, chunk): a 1-D grid, the
// strips of one (batch, head, chunk) together (they share x, C and G in
// L2), heaviest first.  The block, one warpgroup, walks S = ceil(N / 64)
// state tiles (A = exp(cum_i) C_i, B = s_in^T) and then its key tiles (A =
// G . W, B = x).  B is staged two tiles ahead and split into planes; each
// warp reads its A values from L2 into registers a tile ahead, while the
// products are in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan(const T* __restrict__ x, const T* __restrict__ Cm,
               const float* __restrict__ D, const float* __restrict__ cbt,
               const float* __restrict__ states, const float* __restrict__ cd,
               T* __restrict__ y, int L, int H, int dh, int N, int Q, int QP,
               int DHP, int NP, int nc, bool vec_x, bool vec_b) {
  constexpr int LDX = krow_ld<T>(kDH);
  constexpr int LDS = krow_ld<float>(kDH);
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* hi_s = reinterpret_cast<uint32_t*>(smem);  // B hi plane
  uint32_t* lo_s = hi_s + kPlane;                      // B lo plane
  unsigned char* raw = smem + 2 * kPlane * 4;          // 2 raw B tiles
  float2* cd_s = reinterpret_cast<float2*>(raw + 2 * kRawBytes);  // QP

  const int strips = QP / kTile;
  const int bhc = blockIdx.x / strips;                // (b * H + h) * nc + c
  const int it = strips - 1 - (blockIdx.x - bhc * strips);
  const int c = bhc % nc, h = (bhc / nc) % H, b = bhc / nc / H;
  const int i0 = it * kTile;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
  const size_t xrow = static_cast<size_t>(H) * dh;
  const T* xc = x + row0 * xrow + static_cast<size_t>(h) * dh;
  const float* st = states + static_cast<size_t>(bhc) * NP * DHP;
  const int S = (N + kTile - 1) / kTile;
  const int n_tiles = S + it + 1;

  const float* cdc = cd + static_cast<size_t>(bhc) * QP * 2;
  for (int e = threadIdx.x; e < QP / 2; e += kThreads)
    cp_async<16>(cd_s + 2 * e, cdc + 4 * e);
  auto stage_tile = [&](int u) {
    unsigned char* buf = raw + (u & 1) * kRawBytes;
    if (u < S)
      stage<float, kDH, LDS>(reinterpret_cast<float*>(buf),
                             st + u * kTile * DHP, DHP, NP - u * kTile, DHP,
                             true);
    else if (u < n_tiles)
      stage<T, kDH, LDX>(reinterpret_cast<T*>(buf),
                         xc + (u - S) * kTile * xrow, xrow,
                         Q - (u - S) * kTile, dh, vec_x);
    cp_async_commit();    // empty past the last tile: one group a tile
  };
  stage_tile(0);
  stage_tile(1);

  const int ri = i0 + 16 * warp + g;                  // rows ri and ri + 8
  const float* g0 = cbt + ((static_cast<size_t>(b) * nc + c) * QP + ri) * QP
                    + 2 * t;
  const float* g1 = g0 + 8 * static_cast<size_t>(QP);
  const T* c0 = Cm + (row0 + (ri < Q ? ri : 0)) * N + 2 * t;
  const T* c1 = Cm + (row0 + (ri + 8 < Q ? ri + 8 : 0)) * N + 2 * t;
  // this warp's A values of tile u: a[kk] = (A[g][k], A[g + 8][k],
  // A[g][k + 1], A[g + 8][k + 1]) at k = 8kk + 2t of the tile
  auto load_a = [&](float (&a)[8][4], int u) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float2 p0, p1;
      if (u < S) {
        const int k = u * kTile + 8 * kk;
        p0 = ri < Q ? load_pair(c0, k, N - 2 * t, vec_b)
                    : make_float2(0.0f, 0.0f);
        p1 = ri + 8 < Q ? load_pair(c1, k, N - 2 * t, vec_b)
                        : make_float2(0.0f, 0.0f);
      } else {
        const int k = (u - S) * kTile + 8 * kk;
        p0 = *reinterpret_cast<const float2*>(g0 + k);
        p1 = *reinterpret_cast<const float2*>(g1 + k);
      }
      a[kk][0] = p0.x;
      a[kk][1] = p1.x;
      a[kk][2] = p0.y;
      a[kk][3] = p1.y;
    }
  };
  float a[8][4];
  load_a(a, 0);

  float acc[8][4] = {};
  float cum0 = 0.0f, cum1 = 0.0f;
  for (int u = 0; u < n_tiles; ++u) {
    cp_async_wait<1>();
    __syncthreads();      // raw B of tile u in; the last products are done
    if (u == 0) {
      cum0 = cd_s[ri].x;
      cum1 = cd_s[ri + 8].x;
    }
    const unsigned char* buf = raw + (u & 1) * kRawBytes;
    if (u < S)
      split_b<float, LDS, false>(hi_s, lo_s,
                                 reinterpret_cast<const float*>(buf),
                                 nullptr);
    else
      split_b<T, LDX, false>(hi_s, lo_s, reinterpret_cast<const T*>(buf),
                             nullptr);
    // the planes' stores, made by the generic proxy, visible to wgmma's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();      // the planes are in place; raw B of tile u is free
    stage_tile(u + 2);

    if (u < S) {          // the carried-in state: exp(cum_i) C_i s_in^T
      const float e0 = ri < Q ? expf(cum0) : 0.0f;
      const float e1 = ri + 8 < Q ? expf(cum1) : 0.0f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        a[kk][0] *= e0;
        a[kk][1] *= e1;
        a[kk][2] *= e0;
        a[kk][3] *= e1;
      }
    } else {              // the chunk's own rows: (G . W) x
      const int j0 = (u - S) * kTile;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int j = j0 + 8 * kk + 2 * t;            // keys j and j + 1
        const float4 cj = *reinterpret_cast<const float4*>(cd_s + j);
        // decay weights, 0 above the diagonal before any exp
        a[kk][0] *= ri >= j ? __expf(cum0 - cj.x) * cj.y : 0.0f;
        a[kk][1] *= ri + 8 >= j ? __expf(cum1 - cj.x) * cj.y : 0.0f;
        a[kk][2] *= ri >= j + 1 ? __expf(cum0 - cj.z) * cj.w : 0.0f;
        a[kk][3] *= ri + 8 >= j + 1 ? __expf(cum1 - cj.z) * cj.w : 0.0f;
      }
    }
    wgmma_tile(acc, a, hi_s, lo_s, [&](float (&next)[8][4]) {
      if (u + 1 < n_tiles) load_a(next, u + 1);
    });
  }

  // y = acc + D x, x from the diagonal tile (the last raw B, still staged)
  const float Dh = D[h];
  const T* xd = reinterpret_cast<const T*>(raw + ((n_tiles - 1) & 1)
                                           * kRawBytes)
                + (16 * warp + g) * LDX + 2 * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = ri + 8 * half;
    if (row >= Q) continue;
    T* yr = y + (row0 + row) * xrow + static_cast<size_t>(h) * dh + 2 * t;
    const T* xr = xd + 8 * half * LDX;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (d >= dh) break;
      store_pair(yr + nt * 8,
                 acc[nt][2 * half] + Dh * widen(xr[nt * 8]),
                 acc[nt][2 * half + 1] + Dh * widen(xr[nt * 8 + 1]),
                 d + 1 < dh);
    }
  }
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int NPT>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D, void* y,
                   void* state, void* cbt, void* states, void* cd, int B,
                   int L, int H, int dh, int N, int Q, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaGetLastError();
  const int nc = L / Q, QP = round_up(Q, kTile), DHP = round_up(dh, 16),
            NP = round_up(N, 8), strips = QP / kTile;
  const bool vec_x = dh * sizeof(T) % 16 == 0 && aligned16(x);
  const bool vec_b = N * sizeof(T) % 16 == 0 && aligned16(Bm)
                     && aligned16(Cm);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  float* cbtf = static_cast<float*>(cbt);
  float* sf = static_cast<float*>(states);
  float* cdf = static_cast<float*>(cd);
  cudaError_t err;

  const size_t smem_a = 2 * kTile * pair_ld(NPT) * sizeof(T);
  err = cudaFuncSetAttribute(ssd_chunk_cbt<T, NPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_a));
  if (err != cudaSuccess) return err;
  ssd_chunk_cbt<T, NPT><<<dim3(strips * (strips + 1) / 2, nc, B), kThreads,
                          smem_a, stream>>>(bt, ct, cbtf, L, N, Q, QP, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_b = 2 * kPlane * 4 + 2 * kRawBytes
                        + 2 * QP * sizeof(float);
  err = cudaFuncSetAttribute(ssd_chunk_states<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return err;
  ssd_chunk_states<T><<<dim3(nc * ((N + kTile - 1) / kTile), H, B), kThreads,
                         smem_b, stream>>>(
      xt, static_cast<const float*>(dt), static_cast<const float*>(A), bt, sf,
      cdf, L, H, dh, N, Q, QP, DHP, NP, vec_x, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_chunk_pass<<<dim3(B * H, (DHP * NP / 4 + kPassThreads - 1)
                                   / kPassThreads),
                   kPassThreads, 0, stream>>>(
      sf, cdf, static_cast<float*>(state), dh, N, Q, QP, DHP, NP, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_d = 2 * kPlane * 4 + 2 * kRawBytes + QP * sizeof(float2);
  err = cudaFuncSetAttribute(ssd_chunk_scan<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_d));
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<T><<<B * H * nc * strips, kThreads, smem_d, stream>>>(
      xt, ct, static_cast<const float*>(D), cbtf, sf, cdf,
      static_cast<T*>(y), L, H, dh, N, Q, QP, DHP, NP, nc, vec_x, vec_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* D, void* y,
                     void* state, void* cbt, void* states, void* cd, int B,
                     int L, int H, int dh, int N, int Q,
                     cudaStream_t stream) {
  if (N <= 64)
    return launch<T, 64>(x, dt, A, Bm, Cm, D, y, state, cbt, states, cd, B,
                         L, H, dh, N, Q, stream);
  return launch<T, 128>(x, dt, A, Bm, Cm, D, y, state, cbt, states, cd, B, L,
                        H, dh, N, Q, stream);
}

}  // namespace

// y (B, L, H, dh) and the final state (B, H, dh, N) of the SSD scan; bf16
// != 0 marks bfloat16 x, B, C and y (float32 otherwise).  Takes dh <= 64,
// N <= 128, L % Q == 0.  Workspaces, float32, 16-byte aligned, with QP = Q
// rounded up to 64, DHP = dh rounded up to 16, NP = N rounded up to 8 and
// nc = L / Q: cbt (B, nc, QP, QP), states (B, H, nc, NP, DHP), cd (B, H,
// nc, QP, 2).  Returns a cudaError_t; cudaErrorInvalidValue for shapes it
// does not take.
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* D,
                             void* y, void* state, void* cbt, void* states,
                             void* cd, int B, int L, int H, int dh, int N,
                             int Q, int bf16, void* stream) {
  if (dh < 1 || dh > kDH || N < 1 || N > 128 || Q < 1 || L % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch_n<__nv_bfloat16>(
        x, dt, A, Bm, Cm, D, y, state, cbt, states, cd, B, L, H, dh, N, Q,
        s));
  return static_cast<int>(launch_n<float>(x, dt, A, Bm, Cm, D, y, state, cbt,
                                          states, cd, B, L, H, dh, N, Q, s));
}
