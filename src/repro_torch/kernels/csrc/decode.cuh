// Lane decode shared by the chunk-batch kernels (sem_spmm.cu, the gather
// kernel, and sem_spmm_mxu.cu, the densify kernel), so both read a chunk's
// index lanes integer for integer alike; with the helpers both use around
// it (operand widening, the bfloat16 epilogue, vector reductions).
//
// Mirrors the JAX package's repro/kernels/sem_spmm.py::_decode_lanes:
//   * uint16 / int32 planes are upcast, for the live lanes i < nnz;
//   * uint8 column planes mark an optimized store's flattened-key deltas:
//     k = meta[g,4]*T + meta[g,5] + inclusive_cumsum(rows << 8 | cols),
//     r = k / T, c = k - r*T, for every lane i < C, lanes >= nnz set to 0.
//     The cumsum is a block scan: each thread sums a contiguous run of
//     lanes, block_exclusive_scan of the run sums gives every run its
//     starting key, and the thread walks its run again.  Keys are 64-bit;
//     the reference's int32 keys agree while meta[g,4]*T + T*T < 2**31.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// An operand element as float: float32 as it is, bfloat16 widened.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The one-shot product with a bfloat16 operand sums in a float32 scratch
// accumulator and writes its bfloat16 output once, here, at the end.
__global__ void f32_to_bf16_kernel(const float* __restrict__ in,
                                   __nv_bfloat16* __restrict__ out,
                                   long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = __float2bfloat16_rn(in[i]);
}

inline cudaError_t write_bf16(const void* acc, void* out, long long n,
                              cudaStream_t stream) {
  if (n > 0) {
    const long long blocks = (n + 255) / 256;
    f32_to_bf16_kernel<<<static_cast<int>(blocks < 65536 ? blocks : 65536),
                         256, 0, stream>>>(
        static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(out), n);
  }
  return cudaGetLastError();
}

// out[0:n] += v[0:n] (n <= 4): one vector reduction (red.global.add.v4.f32,
// atomicAdd on a float4 on sm_90) where n == 4 and the address is 16-byte
// aligned (vec), scalar reductions otherwise.
__device__ __forceinline__ void add4(float* out, const float (&v)[4], int n,
                                     bool vec) {
  if (vec && n == 4) {
    atomicAdd(reinterpret_cast<float4*>(out),
              make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
  for (int e = 0; e < n; ++e) atomicAdd(out + e, v[e]);
}

// Exclusive prefix sum over the block of one value per thread: a warp
// scan by shuffles, then the warps' sums through shared memory.  Every
// thread of the block calls it (kThreads a multiple of 32); *total gets
// the block's sum.  Integer sums are exact in any order.
template <int kThreads, typename V>
__device__ __forceinline__ V block_exclusive_scan(V x, V* total) {
  constexpr int kWarps = kThreads / 32;
  __shared__ V warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  V incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const V y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  V before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const V s = warp_sum[w];
    before += w < warp ? s : V(0);
    all += s;
  }
  __syncthreads();  // warp_sum is free for the next scan
  *total = all;
  return before + incl - x;
}

template <int kThreads, typename RowT, typename ColT>
__device__ __forceinline__ void decode_lanes(const int32_t* m, const RowT* rg,
                                             const ColT* cg, int C, int T,
                                             int nnz, int* r_s, int* c_s) {
  if constexpr (sizeof(ColT) == 1) {
    const int per = (C + kThreads - 1) / kThreads;
    const int lo = min(static_cast<int>(threadIdx.x) * per, C);
    const int hi = min(lo + per, C);
    long long s = 0;
    for (int i = lo; i < hi; ++i)
      s += (static_cast<long long>(rg[i]) << 8) | static_cast<long long>(cg[i]);
    long long total;
    long long k = static_cast<long long>(m[4]) * T + m[5]
                  + block_exclusive_scan<kThreads>(s, &total);
    for (int i = lo; i < hi; ++i) {
      k += (static_cast<long long>(rg[i]) << 8) | static_cast<long long>(cg[i]);
      const long long r = k / T;
      const bool live = i < nnz;
      r_s[i] = live ? static_cast<int>(r) : 0;
      c_s[i] = live ? static_cast<int>(k - r * T) : 0;
    }
  } else {
    for (int i = threadIdx.x; i < nnz; i += kThreads) {
      r_s[i] = static_cast<int>(rg[i]);
      c_s[i] = static_cast<int>(cg[i]);
    }
  }
}
