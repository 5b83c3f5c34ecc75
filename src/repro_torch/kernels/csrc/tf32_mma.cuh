// Float32 products on the tensor cores through TF32, cp.async staging and
// wgmma's plumbing, shared by the densify kernel (sem_spmm_mxu.cu,
// mma.sync), the flash-attention kernel (flash_attention.cu, the same split
// through wgmma) and the SSD chunk scan (ssd_chunk.cu, wgmma).
//
// mma.sync m16n8k8 takes TF32 operands (10 mantissa bits) and sums in
// float32.  A float32 value x splits as hi = tf32(x), lo = tf32(x - hi):
// hi + lo keeps 22 significant bits of x, so a term carries a relative
// error below 2**-21.
//   * densify: the one-hot factor is exact in TF32, so two products,
//     E . hi(s) + E . lo(s), carry s to 22 bits;
//   * flash attention: both factors are float32, so three products,
//     a_hi b_hi + a_hi b_lo + a_lo b_hi (a_lo b_lo, below 2**-22 of the
//     term, is left out), carry a . b to about 2**-21 relative a term.
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32; wgmma's m64nNk8 gives each
// warp of a warpgroup the same for its 16 rows), groupID g = lane / 4 and
// thread-in-group t = lane % 4:
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8):       c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// x rounded to TF32 as cvt.rna does (to nearest, ties away from zero), in
// a 32-bit register with the low 13 bits clear.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// The TF32 high and low parts of x (hi + lo = x to 22 bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Whether x splits into finite parts: finite, and below the least float
// that cvt.rna rounds up to inf (0x7f7ff000).  NaN is not.
__device__ __forceinline__ bool tf32_splittable(float x) {
  return fabsf(x) < __uint_as_float(0x7f7ff000u);
}

// d += A . B, one m16n8k8 TF32 product (fragments as above).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous global-to-shared copy of kBytes (16 or 4), of which the
// first src_bytes come from src and the rest are zero (0: a zero fill).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes = kBytes) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending committed groups of this thread are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

constexpr uint32_t kLBO = 128;   // wgmma B: bytes to the next 4 columns of k
constexpr uint32_t kSBO = 256;   // wgmma B: bytes to the next 8 rows of n

// The wgmma descriptor of a B operand at p: core matrices of 8 rows of 16
// bytes, no swizzle, kLBO apart along k and kSBO apart along n.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kLBO >> 4) << 16)
         | (static_cast<uint64_t>(kSBO >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins the order of accumulator accesses around asynchronous wgmma: no read
// or write of d moves across it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e]) :: "memory");
}
