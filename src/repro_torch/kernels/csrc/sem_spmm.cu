// Chunk-batch gather kernel of the semi-external SpMM pass, for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/sem_spmm.py::spmm_tiles_acc, variant "gather"
// (body _stream_gather_body, helpers _decode_lanes, _gather_contrib,
// _live_lanes).  The one-shot spmm_tiles (gather body _gather_body) is the
// same kernel run on a zeroed accumulator with n_valid = n_chunks.
//
// X may be float32 or, in the one-shot product, bfloat16: each element is
// widened to float32 as it is gathered, the sums stay float32 in the
// accumulator, and the entry point writes the bfloat16 output once at the
// end (decode.cuh, write_bf16).
//
// Contract, per chunk g of a batch (one thread block per chunk):
//   * g >= n_valid[0]: the block returns at once (fixed-shape tail pads).
//     n_valid, not the chunk's nnz, is the gate: an empty tile row's real
//     chunk has nnz 0 and still runs (it just adds nothing here).
//   * decode the C index lanes (decode.cuh, shared with the densify
//     kernel): uint16 / int32 planes are upcast; uint8 delta planes (an
//     optimized store) rebuild the flattened key with a block scan --
//     integer for integer what the reference decodes.
//   * for every live lane (lane < meta[g,3]) and column j < p:
//       acc[(meta[g,0]*T + r)*p + j] += v * x_pad[(meta[g,1]*T + c)*p + j]
//     with v the stored value, or 1 for a binary store (no value plane).
//     Lanes at or past the chunk's nnz hold value 0 in every store the
//     writer produces, so skipping them equals the reference for any
//     finite operand.  Stored first-flags (meta[:,2]) are ignored: the sum
//     goes straight into the accumulator, so no window needs seeding, and
//     tile rows outside the batch are never written.
//
// Bound on this card: bytes.  Per batch the kernel must read the index and
// value planes and meta, gather the X rows the chunks name and read and
// write the accumulator rows they update; its 2*nnz*p flops are nothing next
// to that.  Least time = those bytes / 3.35 TB/s (HBM3, H100 SXM).
//
// This first design is correctness-first: one block per chunk, the lanes'
// indices decoded into shared memory, then a flat walk over (lane, column)
// pairs with one atomicAdd per pair, so neighbouring threads gather and
// update neighbouring floats of one row.  A later design would give a block
// a run of one tile row's chunks and accumulate a p-slice of the tile row
// in shared memory (a whole tile row is T*p*4 = 512 KB at T = 16384, p = 8,
// more than the 227 KB a block may use), stage the index planes with TMA,
// and aggregate atomics within a warp where lanes share a row.
//
// The host entry point has a plain C interface (loaded with ctypes; no
// PyTorch headers, which keeps the build to seconds).  It launches on the
// stream it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller sees a refused launch at once.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

constexpr int kThreads = 512;

template <typename RowT, typename ColT, bool kBinary, typename XT>
__global__ void __launch_bounds__(kThreads)
chunk_gather_kernel(const int32_t* __restrict__ meta, int meta_ints,
                    const int32_t* __restrict__ n_valid,
                    const RowT* __restrict__ rows,
                    const ColT* __restrict__ cols,
                    const float* __restrict__ vals,
                    const XT* __restrict__ x_pad,
                    float* __restrict__ acc, int C, int T, int p) {
  const int g = blockIdx.x;
  if (g >= __ldg(n_valid)) return;
  const int32_t* m = meta + static_cast<size_t>(g) * meta_ints;
  const int tile_row = m[0];
  const int tile_col = m[1];
  const int nnz = min(m[3], C);

  extern __shared__ int lane_idx[];
  int* r_s = lane_idx;       // C decoded row indices
  int* c_s = lane_idx + C;   // C decoded column indices
  decode_lanes<kThreads>(m, rows + static_cast<size_t>(g) * C,
                         cols + static_cast<size_t>(g) * C, C, T, nnz, r_s,
                         c_s);
  __syncthreads();

  const XT* xb = x_pad + static_cast<size_t>(tile_col) * T * p;
  float* ob = acc + static_cast<size_t>(tile_row) * T * p;
  const float* vg = kBinary ? nullptr : vals + static_cast<size_t>(g) * C;
  const int work = nnz * p;
  for (int t = threadIdx.x; t < work; t += kThreads) {
    const int lane = t / p;
    const int j = t - lane * p;
    const float xv = to_float(xb[static_cast<size_t>(c_s[lane]) * p + j]);
    const float contrib = kBinary ? xv : __ldg(vg + lane) * xv;
    atomicAdd(ob + static_cast<size_t>(r_s[lane]) * p + j, contrib);
  }
}

template <typename RowT, typename ColT, bool kBinary, typename XT>
cudaError_t launch(const void* meta, int meta_ints, const void* n_valid,
                   const void* rows, const void* cols, const void* vals,
                   const void* x_pad, void* acc, int n_chunks, int C, int T,
                   int p, cudaStream_t stream) {
  auto kernel = chunk_gather_kernel<RowT, ColT, kBinary, XT>;
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(int);
  // Past 48 KB (static shared memory included) a block needs the opt-in.
  if (smem > 40 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (n_chunks > 0) {
    kernel<<<n_chunks, kThreads, smem, stream>>>(
        static_cast<const int32_t*>(meta), meta_ints,
        static_cast<const int32_t*>(n_valid), static_cast<const RowT*>(rows),
        static_cast<const ColT*>(cols), static_cast<const float*>(vals),
        static_cast<const XT*>(x_pad), static_cast<float*>(acc), C, T, p);
  }
  return cudaGetLastError();
}

template <typename RowT, typename ColT>
cudaError_t launch_values(const void* meta, int meta_ints, const void* n_valid,
                          const void* rows, const void* cols, const void* vals,
                          const void* x_pad, int x_bf16, void* acc,
                          int n_chunks, int C, int T, int p,
                          cudaStream_t stream) {
  if (x_bf16) {
    if (vals == nullptr)
      return launch<RowT, ColT, true, __nv_bfloat16>(
          meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
          T, p, stream);
    return launch<RowT, ColT, false, __nv_bfloat16>(
        meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
        T, p, stream);
  }
  if (vals == nullptr)
    return launch<RowT, ColT, true, float>(meta, meta_ints, n_valid, rows,
                                           cols, vals, x_pad, acc, n_chunks,
                                           C, T, p, stream);
  return launch<RowT, ColT, false, float>(meta, meta_ints, n_valid, rows, cols,
                                          vals, x_pad, acc, n_chunks, C, T, p,
                                          stream);
}

cudaError_t dispatch(const void* meta, int meta_ints, const void* n_valid,
                     const void* rows, int row_bytes, const void* cols,
                     int col_bytes, const void* vals, const void* x_pad,
                     int x_bf16, void* acc, int n_chunks, int C, int T, int p,
                     cudaStream_t s) {
  if (row_bytes == 2 && col_bytes == 2)
    return launch_values<uint16_t, uint16_t>(meta, meta_ints, n_valid, rows,
                                             cols, vals, x_pad, x_bf16, acc,
                                             n_chunks, C, T, p, s);
  if (row_bytes == 4 && col_bytes == 4)
    return launch_values<int32_t, int32_t>(meta, meta_ints, n_valid, rows,
                                           cols, vals, x_pad, x_bf16, acc,
                                           n_chunks, C, T, p, s);
  if (row_bytes == 1 && col_bytes == 1)
    return launch_values<uint8_t, uint8_t>(meta, meta_ints, n_valid, rows,
                                           cols, vals, x_pad, x_bf16, acc,
                                           n_chunks, C, T, p, s);
  if (row_bytes == 2 && col_bytes == 1)
    return launch_values<uint16_t, uint8_t>(meta, meta_ints, n_valid, rows,
                                            cols, vals, x_pad, x_bf16, acc,
                                            n_chunks, C, T, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// One chunk batch: acc (n_tile_rows*T, p) += A_batch @ x_pad, in place.
// row_bytes / col_bytes give the index planes' element widths: (2, 2) raw
// uint16, (4, 4) decoded int32, (1, 1) 16-bit and (2, 1) 24-bit flattened
// deltas.  vals == NULL denotes a binary store.  x_bf16 != 0 marks a
// bfloat16 x_pad; then out (n_out bfloat16 elements, or NULL) receives the
// float32 accumulator's n_out first elements once the batch is summed.
// Returns a cudaError_t.
extern "C" int sem_spmm_batch(const void* meta, int meta_ints,
                              const void* n_valid, const void* rows,
                              int row_bytes, const void* cols, int col_bytes,
                              const void* vals, const void* x_pad, int x_bf16,
                              void* acc, void* out, long long n_out,
                              int n_chunks, int C, int T, int p,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(meta, meta_ints, n_valid, rows, row_bytes,
                                   cols, col_bytes, vals, x_pad, x_bf16, acc,
                                   n_chunks, C, T, p, s);
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  return static_cast<int>(write_bf16(acc, out, n_out, s));
}
