// Chunk-batch densify kernel of the semi-external SpMM pass, for sm_90a:
// each chunk's block is two one-hot matrix products on the tensor cores.
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/sem_spmm.py::spmm_tiles_acc, variant "mxu" (body
// _stream_mxu_body, helper _mxu_blk).  The one-shot spmm_tiles, variant
// "mxu" (body _mxu_body), is the same kernel run on a zeroed accumulator
// with n_valid = n_chunks.
//
// Contract, per chunk g of a batch (one thread block per chunk):
//   * g >= n_valid[0]: the block returns at once (fixed-shape tail pads).
//   * decode the C index lanes with decode.cuh, the gather kernel's code;
//   * blk (T, p) = E_r^T . (v (.) (E_c . X[tile_col])), where E_c (C, T)
//     and E_r (C, T) are the one-hot matrices of the lanes' column and row
//     indices and v the stored values (1 for a binary store); lanes at or
//     past the chunk's nnz are rows of zeros in both (the writer stores
//     value 0 there, so for finite operands this is the reference's sum);
//   * acc[tile_row] += blk, over all T rows: a row of a visited tile row
//     that gets no entry receives +0.0, as the reference's out + blk gives
//     it (so a -0.0 there becomes +0.0, bit for bit as in the reference).
//   Stored first flags (meta[:,2]) are ignored; tile rows outside the batch
//   are never written.
//
// Bound on this card: the function is the same as the gather kernel's, so
// its least time is the same bytes (the live lanes of the planes, the X
// rows they name, the accumulator rows they update) over 3.35 TB/s.  The
// densify route itself does 2*n*T*p flops per product, 4*n*T*p per chunk,
// with n the chunk's live lanes rounded up to 16 (4*C*T*p for a full
// chunk), twice over with the split below, at 495 TF32 TFLOP/s.  Which of
// the two kernels is faster at a given T is measured on the card, not
// assumed (kernels/ops.py::pick_variant).
//
// Where the TPU design does not carry over, and what this design does:
//   * No sequential grid.  The Pallas kernel keeps one tile row's (T, p)
//     window in VMEM across that row's consecutive chunks.  Here blocks run
//     in no order, so each block adds its chunk's block into the accumulator
//     with atomics (red.global.add.f32).  A block per run of one tile row's
//     chunks would avoid them, but a 256-chunk batch of a T = 2048 store
//     covers one or two tile rows: that design would leave most SMs idle.
//   * No VMEM-sized operands.  The one-hot matrices are never stored: their
//     mma fragments are built in registers from the decoded indices in
//     shared memory (a compare per element).  X[tile_col] is staged in
//     shared memory in slabs of kTSlab rows and the (n, p) intermediate in
//     slabs of kLaneSlab lanes, 8*NT columns at a time, so every T, C and p
//     fits in a fixed footprint (C bounded only by the decoded indices,
//     12 bytes a lane: C <= 13056).
//   * Precision.  mma.sync m16n8k8 takes TF32 (10 mantissa bits).  The
//     one-hot factors are exact in TF32; X and the scaled intermediate are
//     split as hi = tf32(a), lo = tf32(a - hi) and each product is issued
//     twice, accumulating in f32.  hi + lo keeps 22 significant bits of a,
//     so the gathered value carries a relative error below 2**-21;
//     integer-valued operands below 2**22 are exact, and so is every f32
//     sum of integers below 2**24: on such data the kernel equals the
//     reference bit for bit.
//   * p need not be a multiple of 8 (the mma's n): the ragged columns are
//     staged as zeros and never written back.
//   * Live lanes only.  The lanes of a chunk past its nnz are all-zero rows
//     of both one-hot matrices; the kernel rounds the live count up to 16
//     (the mma's m) and skips the rest, so a chunk costs O(n*T*p), n its
//     live lanes.  The route stays dense: every (lane, t) pair of the live
//     rows goes through the tensor cores.
//
// X may be float32 or, in the one-shot product, bfloat16, widened to float32
// as it is staged; the accumulator stays float32 and the entry point writes
// the bfloat16 output once at the end (decode.cuh, write_bf16).
//
// The host entry point has a plain C interface, like the gather kernel's.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLaneSlab = 256;                 // lanes of S in shared memory
constexpr int kTSlab = 128;                    // rows of X in shared memory
constexpr int kGroupsPerWarp = kLaneSlab / 16 / kWarps;
constexpr uint32_t kOne = 0x3f800000u;         // 1.0f, exact in TF32

// Row stride (in words) of a staged slab holding 8*NT columns: 24 words
// for 16 columns keeps a fragment load free of bank conflicts.
template <int NT>
__host__ __device__ constexpr int stride() { return NT == 1 ? 8 : 24; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// hi/lo split of one value into the staged slab.
__device__ __forceinline__ void put_split(uint32_t* hi, uint32_t* lo, int at,
                                          float a) {
  const uint32_t h = to_tf32(a);
  hi[at] = h;
  lo[at] = to_tf32(a - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename RowT, typename ColT, bool kBinary, int NT, typename XT>
__global__ void __launch_bounds__(kThreads)
chunk_mxu_kernel(const int32_t* __restrict__ meta, int meta_ints,
                 const int32_t* __restrict__ n_valid,
                 const RowT* __restrict__ rows, const ColT* __restrict__ cols,
                 const float* __restrict__ vals,
                 const XT* __restrict__ x_pad, float* __restrict__ acc,
                 int C, int T, int p) {
  constexpr int W = stride<NT>();
  const int g = blockIdx.x;
  if (g >= __ldg(n_valid)) return;
  const int32_t* m = meta + static_cast<size_t>(g) * meta_ints;
  const int tile_row = m[0];
  const int tile_col = m[1];
  const int nnz = min(m[3], C);
  const int c_pad = (C + 15) & ~15;
  const int n_live = (nnz + 15) & ~15;

  extern __shared__ __align__(16) unsigned char smem[];
  int* r_s = reinterpret_cast<int*>(smem);          // c_pad row indices
  int* c_s = r_s + c_pad;                           // c_pad column indices
  float* v_s = reinterpret_cast<float*>(c_s + c_pad);  // c_pad values
  uint32_t* xs_hi = reinterpret_cast<uint32_t*>(v_s + c_pad);
  uint32_t* xs_lo = xs_hi + kTSlab * W;
  uint32_t* ss_hi = xs_lo + kTSlab * W;
  uint32_t* ss_lo = ss_hi + kLaneSlab * W;

  decode_lanes<kThreads>(m, rows + static_cast<size_t>(g) * C,
                         cols + static_cast<size_t>(g) * C, C, T, nnz, r_s,
                         c_s);
  __syncthreads();
  // Dead lanes index nothing (-1 matches no row or column) and weigh 0.
  const float* vg = kBinary ? nullptr : vals + static_cast<size_t>(g) * C;
  for (int i = threadIdx.x; i < c_pad; i += kThreads) {
    const bool live = i < nnz;
    if (!live) {
      r_s[i] = -1;
      c_s[i] = -1;
    }
    v_s[i] = live ? (kBinary ? 1.0f : vg[i]) : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int grp = (threadIdx.x & 31) >> 2;   // mma groupID
  const int tig = threadIdx.x & 3;           // mma thread-in-group
  const XT* xb = x_pad + static_cast<size_t>(tile_col) * T * p;
  float* ob = acc + static_cast<size_t>(tile_row) * T * p;
  const int n_row_groups = (T + 15) / 16;

  for (int j0 = 0; j0 < p; j0 += 8 * NT) {
    int l0 = 0;
    do {  // at least once: an empty chunk still adds +0.0 to its tile row
      const int slab = min(kLaneSlab, n_live - l0);

      // -- product 1: G (slab, 8NT) = E_c[slab] . X[:, j0:j0+8NT] --------
      float d1[kGroupsPerWarp][NT][4] = {};
      int ca[kGroupsPerWarp][2];
      bool active[kGroupsPerWarp];
      #pragma unroll
      for (int q = 0; q < kGroupsPerWarp; ++q) {
        const int base = 16 * (warp + kWarps * q);
        active[q] = base < slab;
        ca[q][0] = active[q] ? c_s[l0 + base + grp] : -1;
        ca[q][1] = active[q] ? c_s[l0 + base + grp + 8] : -1;
      }
      for (int t0 = 0; slab > 0 && t0 < T; t0 += kTSlab) {
        __syncthreads();  // the previous slab's readers are done
        for (int e = threadIdx.x; e < kTSlab * 8 * NT; e += kThreads) {
          const int t = e / (8 * NT);
          const int n = e - t * (8 * NT);
          const float xv = (t0 + t < T && j0 + n < p)
              ? to_float(xb[static_cast<size_t>(t0 + t) * p + j0 + n])
              : 0.0f;
          put_split(xs_hi, xs_lo, t * W + n, xv);
        }
        __syncthreads();
#pragma unroll 4
        for (int k8 = 0; k8 < kTSlab; k8 += 8) {
          uint32_t bh[NT][2], bl[NT][2];
          #pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int at = (k8 + tig) * W + nt * 8 + grp;
            bh[nt][0] = xs_hi[at];
            bh[nt][1] = xs_hi[at + 4 * W];
            bl[nt][0] = xs_lo[at];
            bl[nt][1] = xs_lo[at + 4 * W];
          }
          const int tk = t0 + k8 + tig;
          #pragma unroll
          for (int q = 0; q < kGroupsPerWarp; ++q) {
            if (!active[q]) continue;
            const uint32_t a[4] = {ca[q][0] == tk ? kOne : 0u,
                                   ca[q][1] == tk ? kOne : 0u,
                                   ca[q][0] == tk + 4 ? kOne : 0u,
                                   ca[q][1] == tk + 4 ? kOne : 0u};
            #pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma_tf32(d1[q][nt], a, bh[nt][0], bh[nt][1]);
              mma_tf32(d1[q][nt], a, bl[nt][0], bl[nt][1]);
            }
          }
        }
      }

      // -- S = v (.) G, split, into shared memory (slab-local lanes) -------
      #pragma unroll
      for (int q = 0; q < kGroupsPerWarp; ++q) {
        if (!active[q]) continue;
        const int li = 16 * (warp + kWarps * q) + grp;
        const float v0 = v_s[l0 + li];
        const float v1 = v_s[l0 + li + 8];
        #pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = nt * 8 + 2 * tig;
          put_split(ss_hi, ss_lo, li * W + col, __fmul_rn(v0, d1[q][nt][0]));
          put_split(ss_hi, ss_lo, li * W + col + 1,
                    __fmul_rn(v0, d1[q][nt][1]));
          put_split(ss_hi, ss_lo, (li + 8) * W + col,
                    __fmul_rn(v1, d1[q][nt][2]));
          put_split(ss_hi, ss_lo, (li + 8) * W + col + 1,
                    __fmul_rn(v1, d1[q][nt][3]));
        }
      }
      __syncthreads();

      // -- product 2: blk (T, 8NT) += E_r[slab]^T . S, added to acc ---------
      for (int rg = warp; rg < n_row_groups; rg += kWarps) {
        const int ta = rg * 16 + grp;
        const int tb = ta + 8;
        float d2[NT][4] = {};
        for (int k8 = 0; k8 < slab; k8 += 8) {
          const int ra = r_s[l0 + k8 + tig];
          const int rb = r_s[l0 + k8 + tig + 4];
          const uint32_t a[4] = {ra == ta ? kOne : 0u, ra == tb ? kOne : 0u,
                                 rb == ta ? kOne : 0u, rb == tb ? kOne : 0u};
          #pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int at = (k8 + tig) * W + nt * 8 + grp;
            mma_tf32(d2[nt], a, ss_hi[at], ss_hi[at + 4 * W]);
            mma_tf32(d2[nt], a, ss_lo[at], ss_lo[at + 4 * W]);
          }
        }
        #pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          for (int h = 0; h < 2; ++h) {
            const int col = j0 + nt * 8 + 2 * tig + h;
            if (col >= p) continue;
            if (ta < T) atomicAdd(ob + static_cast<size_t>(ta) * p + col,
                                  d2[nt][h]);
            if (tb < T) atomicAdd(ob + static_cast<size_t>(tb) * p + col,
                                  d2[nt][2 + h]);
          }
        }
      }
      __syncthreads();  // S and X slabs are reused by the next slab or pass
      l0 += kLaneSlab;
    } while (l0 < n_live);
  }
}

// Dynamic shared memory of one block: the decoded lanes and values, one X
// slab and one S slab, each split in hi and lo.
size_t smem_bytes(int C, int p) {
  const size_t c_pad = (static_cast<size_t>(C) + 15) & ~static_cast<size_t>(15);
  const int W = p <= 8 ? stride<1>() : stride<2>();
  return 12 * c_pad + 8 * static_cast<size_t>(W) * (kTSlab + kLaneSlab);
}

template <typename RowT, typename ColT, bool kBinary, int NT, typename XT>
cudaError_t launch(const void* meta, int meta_ints, const void* n_valid,
                   const void* rows, const void* cols, const void* vals,
                   const void* x_pad, void* acc, int n_chunks, int C, int T,
                   int p, cudaStream_t stream) {
  auto kernel = chunk_mxu_kernel<RowT, ColT, kBinary, NT, XT>;
  const size_t smem = smem_bytes(C, p);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (n_chunks > 0) {
    kernel<<<n_chunks, kThreads, smem, stream>>>(
        static_cast<const int32_t*>(meta), meta_ints,
        static_cast<const int32_t*>(n_valid), static_cast<const RowT*>(rows),
        static_cast<const ColT*>(cols), static_cast<const float*>(vals),
        static_cast<const XT*>(x_pad), static_cast<float*>(acc), C, T, p);
  }
  return cudaGetLastError();
}

template <typename RowT, typename ColT, bool kBinary, typename XT>
cudaError_t launch_width(const void* meta, int meta_ints, const void* n_valid,
                         const void* rows, const void* cols, const void* vals,
                         const void* x_pad, void* acc, int n_chunks, int C,
                         int T, int p, cudaStream_t stream) {
  if (p <= 8)
    return launch<RowT, ColT, kBinary, 1, XT>(meta, meta_ints, n_valid, rows,
                                              cols, vals, x_pad, acc, n_chunks,
                                              C, T, p, stream);
  return launch<RowT, ColT, kBinary, 2, XT>(meta, meta_ints, n_valid, rows,
                                            cols, vals, x_pad, acc, n_chunks,
                                            C, T, p, stream);
}

template <typename RowT, typename ColT>
cudaError_t launch_values(const void* meta, int meta_ints, const void* n_valid,
                          const void* rows, const void* cols, const void* vals,
                          const void* x_pad, int x_bf16, void* acc,
                          int n_chunks, int C, int T, int p,
                          cudaStream_t stream) {
  if (x_bf16) {
    if (vals == nullptr)
      return launch_width<RowT, ColT, true, __nv_bfloat16>(
          meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
          T, p, stream);
    return launch_width<RowT, ColT, false, __nv_bfloat16>(
        meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
        T, p, stream);
  }
  if (vals == nullptr)
    return launch_width<RowT, ColT, true, float>(meta, meta_ints, n_valid,
                                                 rows, cols, vals, x_pad, acc,
                                                 n_chunks, C, T, p, stream);
  return launch_width<RowT, ColT, false, float>(meta, meta_ints, n_valid, rows,
                                                cols, vals, x_pad, acc,
                                                n_chunks, C, T, p, stream);
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

// One chunk batch by densifying: acc (n_tile_rows*T, p) += A_batch @ x_pad,
// in place.  Arguments as sem_spmm_batch's (sem_spmm.cu), bfloat16 operand
// and output included.  Returns a cudaError_t; cudaErrorInvalidValue for
// planes it does not take.
extern "C" int sem_spmm_mxu_batch(const void* meta, int meta_ints,
                                  const void* n_valid, const void* rows,
                                  int row_bytes, const void* cols,
                                  int col_bytes, const void* vals,
                                  const void* x_pad, int x_bf16, void* acc,
                                  void* out, long long n_out, int n_chunks,
                                  int C, int T, int p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(meta, meta_ints, n_valid, rows, row_bytes,
                                   cols, col_bytes, vals, x_pad, x_bf16, acc,
                                   n_chunks, C, T, p, s);
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  return static_cast<int>(write_bf16(acc, out, n_out, s));
}
