// Float32 tile products on the CUDA cores, for the SSD chunk kernel
// (ssd_chunk.cu).
//
// A block of kTileThreads = 256 threads computes a 64-row output tile.
// Thread t = 16*ty + tx owns rows r0 = 4*ty .. 4*ty+3 and columns
// tx + 16*j, j < NJ, so a warp's two row groups share every column load and
// the 16 threads of one row group share every row load (broadcast).  Each
// routine adds one product into the thread's acc[4][NJ], one float32 FMA
// per term, in the order of the inner index.  Operands are float32 in
// shared memory, row-major:
//   fma_abt: acc[i][j] += sum_k A[r0+i][k] * B[tx+16j][k]   (A . B^T)
//   fma_ab:  acc[i][j] += sum_k A[r0+i][k] * B[k][tx+16j]   (A . B)
//   fma_atb: acc[i][j] += sum_k A[k][r0+i] * B[k][tx+16j]   (A^T . B)
// K is a multiple of 4 and every leading dimension a multiple of 4 (16-byte
// vector loads).  A leading dimension that is 4 times an odd number
// (row_stride) keeps fma_abt's column loads free of bank conflicts: the
// eight threads of a quarter warp then read eight disjoint groups of four
// banks.

#pragma once

constexpr int kTileThreads = 256;
constexpr int kTileRows = 64;

// Row stride, in floats, of a shared tile holding `cols` columns.
__host__ __device__ constexpr int row_stride(int cols) {
  return ((cols + 3) / 4) % 2 ? (cols + 3) / 4 * 4 : (cols + 3) / 4 * 4 + 4;
}

template <int NJ>
__device__ __forceinline__ void fma_abt(float (&acc)[4][NJ],
                                        const float* __restrict__ A, int lda,
                                        const float* __restrict__ B, int ldb,
                                        int K, int r0, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

template <int NJ>
__device__ __forceinline__ void fma_ab(float (&acc)[4][NJ],
                                       const float* __restrict__ A, int lda,
                                       const float* __restrict__ B, int ldb,
                                       int K, int r0, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float b[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = B[(k + q) * ldb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                       : q == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

template <int NJ>
__device__ __forceinline__ void fma_atb(float (&acc)[4][NJ],
                                        const float* __restrict__ A, int lda,
                                        const float* __restrict__ B, int ldb,
                                        int K, int r0, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * lda + r0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float b[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
  }
}
