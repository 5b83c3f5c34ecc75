// Chunk-batch gather kernel of the semi-external SpMM pass, for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/sem_spmm.py::spmm_tiles_acc, variant "gather"
// (body _stream_gather_body, helpers _decode_lanes, _gather_contrib,
// _live_lanes, _merge_block).  The one-shot spmm_tiles (gather body
// _gather_body) is the same kernel run on a zeroed accumulator with
// n_valid = n_chunks.
//
// X may be float32 or, in the one-shot product, bfloat16: each element is
// widened to float32 as it is gathered, the sums stay float32 in the
// accumulator, and the entry point writes the bfloat16 output once at the
// end (decode.cuh, write_bf16).
//
// Contract, per chunk g of a batch:
//   * g >= n_valid[0]: nothing (fixed-shape tail pads).  n_valid, not the
//     chunk's nnz, is the gate: an empty tile row's real chunk has nnz 0
//     and still counts (its tile row takes the +0.0 rule below).
//   * decode the C index lanes (decode.cuh, shared with the densify
//     kernel): uint16 / int32 planes are upcast; uint8 delta planes (an
//     optimized store) rebuild the flattened key with a block scan --
//     integer for integer what the reference decodes.
//   * for every live lane (lane < meta[g,3]) and column j < p:
//       acc[(meta[g,0]*T + r)*p + j] += v * x_pad[(meta[g,1]*T + c)*p + j]
//     with v the stored value, or 1 for a binary store (no value plane).
//     Stored first-flags (meta[:,2]) are ignored: the sum goes straight
//     into the accumulator, so no window needs seeding.
//   * the +0.0 rule: no element of a tile row that a valid chunk visits is
//     -0.0 afterwards, as in the reference, whose block starts at +0.0 and
//     is added into the whole tile row (core/sem.py::_scan_batch;
//     _merge_block's acc + blk).  Tile rows outside the batch are never
//     written.  The one-shot product's accumulator is fresh (+0.0), where
//     the rule has nothing to do: the caller says so (fresh) and the sweep
//     below is not launched.
//
// Bound on this card: bytes.  Per batch the kernel must read the planes'
// live lanes and meta, gather the X rows the lanes name, read the visited
// tile rows (the +0.0 rule) and write the accumulator rows the lanes
// update; its 2*nnz*p flops are nothing next to that.  Least time = those
// bytes / 3.35 TB/s (HBM3, H100 SXM).
//
// Design.  The kernel before this one (one block per chunk, a scalar
// atomicAdd per lane and column) spent its time in the atomics: made plain
// stores, they took 56% (p = 1) and 29% (p = 8) off a 256-chunk batch and
// 79% and 45% off the whole matrix, while the X gather cost at most 16%
// (kernels/tune_gather.py; PERF.md, section 6).  Same-address atomics
// serialise, and the R-MAT rows near the top of each tile row gather many
// lanes of a chunk (median 200, up to all 2048).  So:
//   1. One thread per lane and up to 4 columns: a 16-byte X load (8 bytes
//      for bfloat16) and one red.global.add.v4.f32 (decode.cuh::add4) in
//      place of 4 scalar loads and 4 atomics; scalar ones for a ragged p or
//      a misaligned operand.  A thread takes kLanes lanes a step (kThreads
//      apart, so each warp still holds 32 neighbouring lanes) and issues
//      all their X loads before it looks for runs or sums any.
//   2. One reduction per run of a row: a warp sums neighbouring lanes of
//      the same row with shuffles (a segmented suffix sum over the warp's
//      runs, as many doubling steps as its longest run needs), and the
//      run's first lane issues the reduction.  A run is a maximal group of
//      neighbouring lanes with one row, so the sums are exact for any lane
//      order: a row whose lanes are not neighbours (no writer produces
//      that) is reduced once per run.
//   3. Blocks sized to the launch.  A SEM batch (at most kManyChunks
//      chunks) splits each chunk into slabs of kLanes * kBatchThreads
//      lanes, one step a block, so a full chunk's lanes all run at once and
//      a batch costs about one dependent round of loads; slabs past a
//      chunk's nnz return at once.  A whole matrix gives each chunk one
//      block of kWholeThreads threads that walks its lanes, so the card
//      holds many chunks without a block per slab.  Delta planes need a block scan
//      over the whole chunk before any lane's row is known, so they take a
//      block of kDecodeThreads per chunk, lanes decoded into shared memory.
//   4. The +0.0 rule as a read: extra blocks of the same launch find the
//      visited tile rows in meta (each valid chunk that starts a run of one
//      tile row) and read their slice of each; an element that is -0.0
//      takes one atomicAdd of +0.0.  Addition never makes -0.0 out of
//      anything else, and +0.0 added at any point gives the reference's
//      bits, so the sweep runs beside the lanes' reductions; an accumulator
//      without -0.0 (every pass starts at +0.0) is only read.
//
// The host entry point has a plain C interface (loaded with ctypes; no
// PyTorch headers, which keeps the build to seconds).  It launches on the
// stream it is given, leaves the partition to the blocks (each reads its
// chunk's nnz from meta), allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

constexpr int kBatchThreads = 256;   // a SEM batch: a slab a block
constexpr int kWholeThreads = 128;   // a whole matrix: a chunk a block
constexpr int kDecodeThreads = 512;  // delta planes: a chunk a block
// Lanes a thread takes at a time, their loads in flight together; a slab
// is kLanes * kBatchThreads lanes.
constexpr int kLanes = 2;
// Chunks in a launch above which each chunk gets one block (a whole
// matrix); at or below, a block per slab of each chunk.
constexpr int kManyChunks = 4096;
// Sweep blocks are sized so that each thread reads about kSweepUnits units
// (16 bytes, or 4 where the tile row is not 16-byte aligned) of each
// visited tile row; at most kMaxSweepBlocks.
constexpr int kSweepUnits = 2;
constexpr int kMaxSweepBlocks = 128;
// Widest p whose launch sums one group of 4 columns a pass (else two).
constexpr int kOneGroupMaxP = 4;
constexpr unsigned kFull = 0xffffffffu;

// x[0:4] = X's n (<= 4) elements at src, widened to float32, zeros past n;
// one 16-byte (float32) or 8-byte (bfloat16) load when vec.
__device__ __forceinline__ void load4(const float* src, int n, bool vec,
                                      float (&x)[4]) {
  if (vec && n == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = e < n ? __ldg(src + e) : 0.0f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* src, int n,
                                      bool vec, float (&x)[4]) {
  if (vec && n == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = __bfloat162float(h[e]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = e < n ? to_float(src[e]) : 0.0f;
}

__device__ __forceinline__ bool neg_zero(float v) {
  return __float_as_uint(v) == 0x80000000u;
}

// A thread's lanes of one step (kLanes of them, kThreads apart): whether
// each is live, its decoded row and column, its value (1 for a binary
// store).
struct Lanes {
  bool live[kLanes];
  int r[kLanes], c[kLanes];
  float v[kLanes];
};

// Where a lane's run of one row starts (head) and the doubling steps of the
// segmented suffix sum that adds the run's terms into its first lane: step
// i adds the partial sum 2**i lanes up where that lane is in the same run
// (bit i of takes).  A run is a maximal group of neighbouring live lanes
// with one row; a lane without an entry is a run of its own.
__device__ __forceinline__ void lane_runs(bool live, int r, bool& head,
                                          unsigned& takes, int& steps) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, r, 1);
  head = !live || lane == 0 || prev != r;
  const int run = __popc(__ballot_sync(kFull, head) & (kFull >> (31 - lane)));
  takes = 0;
  steps = 0;
  for (int off = 1; off < 32; off <<= 1) {
    const int other = __shfl_down_sync(kFull, run, off);
    const bool take = lane + off < 32 && other == run;
    if (!__any_sync(kFull, take)) break;
    takes |= static_cast<unsigned>(take) << steps++;
  }
}

// kLanes steps of one warp's lanes (step k: a lane a thread, 32
// neighbouring lanes of one chunk in lane order): every live lane's
// v * X[c, :] added into row r of the chunk's output tile, one reduction
// per run of a row and 4 columns (header, steps 1 and 2).  The steps' X
// loads are issued together, before the runs are found.  Every thread of
// the warp calls it; live is false past the chunk's lanes.
template <bool kBinary, int NQ, typename XT>
__device__ __forceinline__ void warp_lanes(const Lanes& ln, const XT* xb,
                                           float* ob, int p, bool vec_x,
                                           bool vec_out) {
  bool head[kLanes];
  unsigned takes[kLanes];
  int steps[kLanes];
  for (int j0 = 0; j0 < p; j0 += 4 * NQ) {   // NQ groups of 4 columns
    float s[kLanes][NQ][4];
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = min(4, p - j0 - 4 * q);
        if (ln.live[k] && n > 0) {
          load4(xb + static_cast<size_t>(ln.c[k]) * p + j0 + 4 * q, n,
                vec_x, s[k][q]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[k][q][e] = 0.0f;
        }
      }
    if (j0 == 0) {
#pragma unroll
      for (int k = 0; k < kLanes; ++k)
        lane_runs(ln.live[k], ln.r[k], head[k], takes[k], steps[k]);
    }
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      if (!kBinary) {
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[k][q][e] = __fmul_rn(ln.v[k], s[k][q][e]);
      }
      for (int i = 0; i < steps[k]; ++i) {
        const bool take = (takes[k] >> i) & 1u;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j0 + 4 * q + e >= p) continue;   // the same in every thread
            const float y = __shfl_down_sync(kFull, s[k][q][e], 1 << i);
            if (take) s[k][q][e] += y;
          }
      }
      if (ln.live[k] && head[k]) {
        float* orow = ob + static_cast<size_t>(ln.r[k]) * p;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int n = min(4, p - j0 - 4 * q);
          if (n > 0) add4(orow + j0 + 4 * q, s[k][q], n, vec_out);
        }
      }
    }
  }
}

// The +0.0 rule (header, step 4) in sweep block k of K: of every tile row
// that a valid chunk visits, the units [lo, hi) of this block (16 bytes
// each when vec, else 4).
template <int kThreads>
__device__ void sweep_visited(const int32_t* __restrict__ meta, int meta_ints,
                              int nv, float* __restrict__ acc, int T, int p,
                              int k, int K, bool vec) {
  __shared__ int rows_s[kThreads];
  __shared__ int n_rows;
  const long long elems = static_cast<long long>(T) * p;
  const long long units = vec ? elems / 4 : elems;
  const long long lo = units * k / K;
  const long long hi = units * (k + 1) / K;
  for (int g0 = 0; g0 < nv; g0 += kThreads) {
    if (threadIdx.x == 0) n_rows = 0;
    __syncthreads();
    const int g = g0 + threadIdx.x;
    if (g < nv) {
      const int tr = meta[static_cast<size_t>(g) * meta_ints];
      if (g == 0 || meta[static_cast<size_t>(g - 1) * meta_ints] != tr)
        rows_s[atomicAdd(&n_rows, 1)] = tr;
    }
    __syncthreads();
    const int n = n_rows;
    for (int i = 0; i < n; ++i) {
      float* ob = acc + static_cast<size_t>(rows_s[i]) * elems;
#pragma unroll 4
      for (long long u = lo + threadIdx.x; u < hi; u += kThreads) {
        if (vec) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(ob) + u);
          const float e4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (neg_zero(e4[e])) atomicAdd(ob + 4 * u + e, 0.0f);
        } else if (neg_zero(__ldcg(ob + u))) {
          atomicAdd(ob + u, 0.0f);
        }
      }
    }
    __syncthreads();   // rows_s and n_rows are free for the next group
  }
}

// Blocks [0, n_chunks * slabs) take slab (b % slabs) of chunk b / slabs;
// the sweep_blocks after them apply the +0.0 rule.  kDecode: delta planes,
// one slab a chunk, decoded into shared memory first.
template <int kThreads, bool kDecode, typename RowT, typename ColT,
          bool kBinary, int NQ, typename XT>
__global__ void __launch_bounds__(kThreads)
chunk_gather_kernel(const int32_t* __restrict__ meta, int meta_ints,
                    const int32_t* __restrict__ n_valid,
                    const RowT* __restrict__ rows,
                    const ColT* __restrict__ cols,
                    const float* __restrict__ vals,
                    const XT* __restrict__ x_pad, float* __restrict__ acc,
                    int n_chunks, int C, int T, int p, int slabs,
                    int sweep_blocks, int vec_x, int vec_out, int vec_sweep) {
  const int lane_blocks = n_chunks * slabs;
  const int nv = __ldg(n_valid);
  if (static_cast<int>(blockIdx.x) >= lane_blocks) {
    sweep_visited<kThreads>(meta, meta_ints, min(nv, n_chunks), acc, T, p,
                            blockIdx.x - lane_blocks, sweep_blocks,
                            vec_sweep);
    return;
  }
  const int g = blockIdx.x / slabs;
  const int32_t* m = meta + static_cast<size_t>(g) * meta_ints;
  const int tile_row = m[0];
  const int tile_col = m[1];
  const int nnz = max(min(m[3], C), 0);
  const int per = (C + slabs - 1) / slabs;
  const int lo = (blockIdx.x - g * slabs) * per;
  const int hi = min(lo + per, nnz);
  if (g >= nv || lo >= hi) return;

  const XT* xb = x_pad + static_cast<size_t>(tile_col) * T * p;
  float* ob = acc + static_cast<size_t>(tile_row) * T * p;
  const RowT* rg = rows + static_cast<size_t>(g) * C;
  const ColT* cg = cols + static_cast<size_t>(g) * C;
  const float* vg = kBinary ? nullptr : vals + static_cast<size_t>(g) * C;
  int* r_s = nullptr;
  int* c_s = nullptr;
  if constexpr (kDecode) {
    extern __shared__ int lane_idx[];
    r_s = lane_idx;       // C decoded row indices
    c_s = lane_idx + C;   // C decoded column indices
    decode_lanes<kThreads>(m, rg, cg, C, T, nnz, r_s, c_s);
    __syncthreads();
  }
  for (int base = lo; base < hi; base += kLanes * kThreads) {
    Lanes ln;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int l = base + k * kThreads + threadIdx.x;
      ln.live[k] = l < hi;
      ln.r[k] = -1, ln.c[k] = 0, ln.v[k] = 1.0f;
      if (ln.live[k]) {
        if constexpr (kDecode) {
          ln.r[k] = r_s[l];
          ln.c[k] = c_s[l];
        } else {   // uint16 planes read unsigned, int32 as they are
          ln.r[k] = static_cast<int>(__ldg(rg + l));
          ln.c[k] = static_cast<int>(__ldg(cg + l));
        }
        if (!kBinary) ln.v[k] = __ldg(vg + l);
      }
    }
    warp_lanes<kBinary, NQ>(ln, xb, ob, p, vec_x, vec_out);
  }
}

template <int kThreads, bool kDecode, typename RowT, typename ColT,
          bool kBinary, int NQ, typename XT>
cudaError_t launch_shape(const void* meta, int meta_ints, const void* n_valid,
                         const void* rows, const void* cols, const void* vals,
                         const void* x_pad, void* acc, int n_chunks, int C,
                         int T, int p, int slabs, int fresh,
                         cudaStream_t stream) {
  auto kernel = chunk_gather_kernel<kThreads, kDecode, RowT, ColT, kBinary,
                                    NQ, XT>;
  const size_t smem = kDecode ? 2 * static_cast<size_t>(C) * sizeof(int) : 0;
  // Past 48 KB (static shared memory included) a block needs the opt-in.
  if (smem > 40 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // Widest access each address allows: X and accumulator rows start at
  // multiples of p elements, tile rows at multiples of T*p.
  const auto x_at = reinterpret_cast<uintptr_t>(x_pad);
  const auto acc_at = reinterpret_cast<uintptr_t>(acc);
  const int vec_x = x_at % (4 * sizeof(XT)) == 0 && p % 4 == 0;
  const int vec_out = acc_at % 16 == 0 && p % 4 == 0;
  const long long tile = static_cast<long long>(T) * p;
  const int vec_sweep = acc_at % 16 == 0 && tile % 4 == 0;
  const long long units = vec_sweep ? tile / 4 : tile;
  const long long per_block = static_cast<long long>(kSweepUnits) * kThreads;
  const int sweep_blocks = fresh ? 0 : static_cast<int>(
      std::min(static_cast<long long>(kMaxSweepBlocks),
               std::max(1LL, (units + per_block - 1) / per_block)));
  if (n_chunks > 0) {
    kernel<<<n_chunks * slabs + sweep_blocks, kThreads, smem, stream>>>(
        static_cast<const int32_t*>(meta), meta_ints,
        static_cast<const int32_t*>(n_valid), static_cast<const RowT*>(rows),
        static_cast<const ColT*>(cols), static_cast<const float*>(vals),
        static_cast<const XT*>(x_pad), static_cast<float*>(acc), n_chunks, C,
        T, p, slabs, sweep_blocks, vec_x, vec_out, vec_sweep);
  }
  return cudaGetLastError();
}

// Columns a pass: one group of 4 for p <= 4 (fewer registers, so more
// warps in flight at PageRank's p = 1), two above.
template <int kThreads, bool kDecode, typename RowT, typename ColT,
          bool kBinary, typename XT>
cudaError_t launch_route(const void* meta, int meta_ints, const void* n_valid,
                         const void* rows, const void* cols, const void* vals,
                         const void* x_pad, void* acc, int n_chunks, int C,
                         int T, int p, int slabs, int fresh,
                         cudaStream_t stream) {
  if (p <= kOneGroupMaxP)
    return launch_shape<kThreads, kDecode, RowT, ColT, kBinary, 1, XT>(
        meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
        T, p, slabs, fresh, stream);
  return launch_shape<kThreads, kDecode, RowT, ColT, kBinary, 2, XT>(
      meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C, T,
      p, slabs, fresh, stream);
}

// The block shape for the launch (header, step 3).
template <typename RowT, typename ColT, bool kBinary, typename XT>
cudaError_t launch(const void* meta, int meta_ints, const void* n_valid,
                   const void* rows, const void* cols, const void* vals,
                   const void* x_pad, void* acc, int n_chunks, int C, int T,
                   int p, int fresh, cudaStream_t stream) {
  if constexpr (sizeof(ColT) == 1) {
    return launch_route<kDecodeThreads, true, RowT, ColT, kBinary, XT>(
        meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
        T, p, 1, fresh, stream);
  } else {
    if (n_chunks > kManyChunks)
      return launch_route<kWholeThreads, false, RowT, ColT, kBinary, XT>(
          meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks,
          C, T, p, 1, fresh, stream);
    return launch_route<kBatchThreads, false, RowT, ColT, kBinary, XT>(
        meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
        T, p, (C + kLanes * kBatchThreads - 1) / (kLanes * kBatchThreads),
        fresh, stream);
  }
}

template <typename RowT, typename ColT>
cudaError_t launch_values(const void* meta, int meta_ints, const void* n_valid,
                          const void* rows, const void* cols, const void* vals,
                          const void* x_pad, int x_bf16, void* acc,
                          int n_chunks, int C, int T, int p, int fresh,
                          cudaStream_t stream) {
  if (x_bf16) {
    if (vals == nullptr)
      return launch<RowT, ColT, true, __nv_bfloat16>(
          meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
          T, p, fresh, stream);
    return launch<RowT, ColT, false, __nv_bfloat16>(
        meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
        T, p, fresh, stream);
  }
  if (vals == nullptr)
    return launch<RowT, ColT, true, float>(meta, meta_ints, n_valid, rows,
                                           cols, vals, x_pad, acc, n_chunks,
                                           C, T, p, fresh, stream);
  return launch<RowT, ColT, false, float>(meta, meta_ints, n_valid, rows, cols,
                                          vals, x_pad, acc, n_chunks, C, T, p,
                                          fresh, stream);
}

cudaError_t dispatch(const void* meta, int meta_ints, const void* n_valid,
                     const void* rows, int row_bytes, const void* cols,
                     int col_bytes, const void* vals, const void* x_pad,
                     int x_bf16, void* acc, int n_chunks, int C, int T, int p,
                     int fresh, cudaStream_t s) {
  if (row_bytes == 2 && col_bytes == 2)
    return launch_values<uint16_t, uint16_t>(meta, meta_ints, n_valid, rows,
                                             cols, vals, x_pad, x_bf16, acc,
                                             n_chunks, C, T, p, fresh, s);
  if (row_bytes == 4 && col_bytes == 4)
    return launch_values<int32_t, int32_t>(meta, meta_ints, n_valid, rows,
                                           cols, vals, x_pad, x_bf16, acc,
                                           n_chunks, C, T, p, fresh, s);
  if (row_bytes == 1 && col_bytes == 1)
    return launch_values<uint8_t, uint8_t>(meta, meta_ints, n_valid, rows,
                                           cols, vals, x_pad, x_bf16, acc,
                                           n_chunks, C, T, p, fresh, s);
  if (row_bytes == 2 && col_bytes == 1)
    return launch_values<uint16_t, uint8_t>(meta, meta_ints, n_valid, rows,
                                            cols, vals, x_pad, x_bf16, acc,
                                            n_chunks, C, T, p, fresh, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// One chunk batch: acc (n_tile_rows*T, p) += A_batch @ x_pad, in place.
// row_bytes / col_bytes give the index planes' element widths: (2, 2) raw
// uint16, (4, 4) decoded int32, (1, 1) 16-bit and (2, 1) 24-bit flattened
// deltas.  vals == NULL denotes a binary store.  x_bf16 != 0 marks a
// bfloat16 x_pad; then out (n_out bfloat16 elements, or NULL) receives the
// float32 accumulator's n_out first elements once the batch is summed.
// fresh != 0 says acc holds +0.0 alone (the one-shot product), so the
// +0.0 rule has nothing to do.  Returns a cudaError_t.
extern "C" int sem_spmm_batch(const void* meta, int meta_ints,
                              const void* n_valid, const void* rows,
                              int row_bytes, const void* cols, int col_bytes,
                              const void* vals, const void* x_pad, int x_bf16,
                              void* acc, void* out, long long n_out,
                              int n_chunks, int C, int T, int p, int fresh,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(meta, meta_ints, n_valid, rows, row_bytes,
                                   cols, col_bytes, vals, x_pad, x_bf16, acc,
                                   n_chunks, C, T, p, fresh, s);
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  return static_cast<int>(write_bf16(acc, out, n_out, s));
}
