// Chunk-batch densify kernel of the semi-external SpMM pass, for sm_90a:
// each chunk's two one-hot products, applied only where they have ones.
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
//     past the chunk's nnz are rows of zeros in both, and a live lane's
//     term v * x that is not finite is added into its own row alone
//     (route), so NaN and inf reach only the rows whose live lanes meet
//     them: this is the reference's default jnp path (core/spmm.py::
//     _spmm_chunked_impl), for finite and non-finite operands alike;
//   * acc[tile_row] += blk, over all T rows: a row of a visited tile row
//     that gets no entry receives +0.0, as the reference's out + blk gives
//     it (so a -0.0 there becomes +0.0, bit for bit as in the reference).
//   Stored first flags (meta[:,2]) are ignored; tile rows outside the batch
//   are never written.
//
// How the block computes it, so that a chunk costs its n live lanes and not
// its whole T-row tile:
//   1. Compress the rows.  The lanes are decoded into shared memory; a live
//      lane whose row differs from the previous lane's opens a run, and a
//      block scan of those flags (decode.cuh::block_exclusive_scan) gives
//      each lane a compressed row id and the chunk R runs.  The writer sorts
//      a tile's entries by (row, col), so a row is one run and 16
//      consecutive compressed rows own one contiguous range of lanes; a row
//      that does appear in two runs is merely reduced twice.
//   2. E_c as a gather.  The X rows the live lanes name are copied into
//      shared memory with cp.async, a slab of lanes and 8*NT columns at a
//      time, two slabs in flight: 16-byte copies where a row's bytes allow
//      them, 4-byte copies or plain loads where a ragged p or a bfloat16
//      operand does not.  (No TMA: a tensor map moves boxes, not rows
//      picked by index.)  S = v (.) X[c] is formed in float32 as the
//      fragments are loaded: the gather is exact.
//   3. E_r^T on the tensor cores, over the compressed rows only.  For each
//      group of 16 compressed rows a warp builds the one-hot m16n8k8 A
//      fragment in registers from the compressed ids and runs k over that
//      group's lanes only: about (n/8 + R/16) k-steps a chunk, not
//      (T/16)*(n/8).
//   4. Write back only the rows that have entries: one red.global.add.v4.f32
//      (atomicAdd on a float4, sm_90) per compressed row and 4 columns,
//      scalar reductions for a ragged tail of columns or a misaligned
//      accumulator: about n*p/4 reductions a chunk, not T*p.
//   5. The +0.0 rule once per visited tile row and batch: the first
//      kSweepSlices blocks of each run of one tile row's chunks in the batch
//      (the first: g == 0 or meta[g-1,0] != meta[g,0], the reference's
//      _in_batch_first) add +0.0 over the tile row's T*p entries, a slice
//      each, with reductions, since other blocks add into the same rows at
//      the same time.  A block finds its place in the run from its
//      neighbours' tile rows, loaded by one warp lane each.  Adding +0.0
//      commutes bit for bit with every other addition, so the order does
//      not matter.  Tail pads return first and take no part.
//
// Bound on this card: the function is the same as the gather kernel's, so
// its least time is the same bytes (the live lanes of the planes, the X
// rows they name, the accumulator rows they update) over 3.35 TB/s.
//
// Precision.  mma.sync m16n8k8 takes TF32 (10 mantissa bits).  The one-hot
// factor is exact in TF32; S is split as hi = tf32(s), lo = tf32(s - hi)
// and each product is issued twice, accumulating in f32 (tf32_mma.cuh).
// hi + lo keeps 22 significant bits of s, so a term carries a relative
// error below 2**-21; integer-valued operands below 2**22 are exact, and so
// is every f32 sum of integers below 2**24 in any order: on such data the
// kernel equals the reference bit for bit.  A term the split cannot carry
// (NaN, inf, or |s| so large that tf32(s) rounds to inf) would give NaN to
// every row of its 16-row group (0 * inf in the one-hot product).  Such a
// term shows as a non-finite accumulator: the warp then sums that group
// again with the term entering the mma as 0 and reaching its own row by
// one scalar reduction (route).  Finite operands below that size take the
// first sum alone, unchanged bit for bit.
//
// Block size.  A block is one chunk, and its warps are sized to the
// launch: 4 warps (128 threads) while the launch's chunks all fit on the
// card at once, as a 256-chunk SEM batch does, so that each chunk finishes
// soonest; 1 warp past kManyChunks chunks (the one-shot product over a
// whole matrix), so that four times as many chunks are in flight.  A slab
// holds one lane per thread.  Shared memory is 16 bytes a lane (decoded
// rows and columns, compressed ids, run starts) plus two slabs (25.6 KB at
// 4 warps and p > 8, 6.4 KB at 1 warp).  ptxas gives the kernel 48 to 64
// registers; at C = 256 and p = 16 shared memory bounds an SM to 7 blocks
// of 4 warps or 20 of 1 warp.  Capping the registers for more 4-warp blocks
// spilled a few words and measured no faster.
//
// X may be float32 or, in the one-shot product, bfloat16, widened to float32
// as it is consumed; the accumulator stays float32 and the entry point
// writes the bfloat16 output once at the end (decode.cuh, write_bf16).
//
// The host entry point has a plain C interface, like the gather kernel's.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "decode.cuh"
#include "tf32_mma.cuh"

namespace {

// A block is kWarps warps on one chunk, and a slab holds one lane per
// thread (kLaneSlab = 32 * kWarps); the launch picks kWarps (see launch).
constexpr int kWarpsFew = 4;      // a SEM batch: chunks' latency matters
constexpr int kWarpsMany = 1;     // a whole matrix: chunks in flight matter
// Chunks in a launch above which each gets one warp: more than fit on the
// card at once with four warps a chunk (132 SMs x 7 blocks = 924).
constexpr int kManyChunks = 4096;
constexpr int kSweepSlices = 8;                // blocks sharing a +0.0 sweep
constexpr uint32_t kOne = 0x3f800000u;         // 1.0f, exact in TF32

// Row stride (in elements) of a staged slab holding 8*NT columns: 24 words
// for 16 columns keeps a fragment load free of bank conflicts; either
// stride keeps every row 16-byte aligned for float32 and bfloat16.
template <int NT>
__host__ __device__ constexpr int stride() { return NT == 1 ? 8 : 24; }

// S's two TF32 terms through one m16n8k8 product each (the one-hot A
// fragment is exact): d += E . hi(S) + E . lo(S), S = (sa, sb) the B
// fragment.
__device__ __forceinline__ void split_mma(float (&d)[4],
                                          const uint32_t (&af)[4], float sa,
                                          float sb) {
  uint32_t ha, la, hb, lb;
  split_tf32(sa, ha, la);
  split_tf32(sb, hb, lb);
  mma_tf32(d, af, ha, hb);
  mma_tf32(d, af, la, lb);
}

// Terms the split cannot carry (NaN, inf, or so large that the TF32 part
// rounds to inf) entered the careful sweep's mma as 0; this pass over the
// same terms of the thread (lanes [a, b) of the warp's row group, its columns
// below p) adds each such term to its lane's row r_s[lane] by a scalar
// reduction, so a NaN or inf reaches only the rows whose live lanes meet
// it, as in the reference's default path.
template <int NT, typename Term>
__device__ __forceinline__ void route(const Term& term, int a, int b,
                                      const int* r_s, float* ob, int p,
                                      int j0) {
  const int tig = threadIdx.x & 3;
  const int grp = (threadIdx.x & 31) >> 2;
  for (int k8 = a & ~7; k8 < b; k8 += 8)
    for (int l = k8 + tig; l < k8 + 8; l += 4)
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + grp;
        const float s = term(l, col);
        if (!tf32_splittable(s) && l >= a && l < b && j0 + col < p)
          atomicAdd(ob + static_cast<size_t>(r_s[l]) * p + j0 + col, s);
      }
}

// The tile row of a neighbour of chunk g, for the +0.0 sweep: lane i <
// kSweepSlices of each warp loads chunk g - 1 - i's, lane kSweepSlices + i
// chunk g + 1 + i's (-1 outside the batch's valid chunks).  Loaded early,
// used by sweep_zero after the decode.
__device__ __forceinline__ int neighbour_row(const int32_t* meta,
                                             int meta_ints, int g, int nv) {
  const int i = threadIdx.x & 31;
  const int h = i < kSweepSlices ? g - 1 - i : g + 1 + i - kSweepSlices;
  return i < 2 * kSweepSlices && h >= 0 && h < nv
      ? meta[static_cast<size_t>(h) * meta_ints] : -1;
}

// The +0.0 rule for chunk g's tile row (see the header, step 5).
template <int kThreads>
__device__ __forceinline__ void sweep_zero(int nb_row, int row, float* ob,
                                           long long n, bool vec) {
  const unsigned same = __ballot_sync(0xffffffffu, nb_row == row);
  // chunks of this tile row right before g, and right after it (capped)
  const int pos = __ffs(~same) - 1;
  if (pos >= kSweepSlices) return;
  const int after = __ffs(~(same >> kSweepSlices)) - 1;
  const int run = min(kSweepSlices, pos + 1 + after);  // blocks sharing it
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long units = vec ? n / 4 : n;
  for (int s = pos; s < kSweepSlices; s += run) {
    const long long lo = units * s / kSweepSlices;
    const long long hi = units * (s + 1) / kSweepSlices;
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      if (vec)
        add4(ob + 4 * i, zero, 4, true);
      else
        atomicAdd(ob + i, 0.0f);
    }
  }
}

// Copy X rows c_s[l0 .. l1) (columns j0 .. j0 + jn) into a slab, kBytes a
// copy (0: plain loads).  Each row's first element lands at row * W.
template <int kThreads, int NT, int kBytes, typename XT>
__device__ __forceinline__ void stage(XT* xs, const XT* xb, const int* c_s,
                                      int l0, int l1, int j0, int jn, int p) {
  constexpr int W = stride<NT>();
  constexpr int V = kBytes ? kBytes / static_cast<int>(sizeof(XT)) : 1;
  constexpr int kPer = 8 * NT / V;     // copies per row
  const int used = (jn + V - 1) / V;
  for (int e = threadIdx.x; e < (l1 - l0) * kPer; e += kThreads) {
    const int l = e / kPer;
    const int q = e - l * kPer;
    XT* dst = xs + l * W + q * V;
    if (q >= used) {   // columns past p: zeros, so the sums there stay finite
      if constexpr (kBytes == 16)
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      else if constexpr (kBytes == 4)
        *reinterpret_cast<uint32_t*>(dst) = 0u;
      else
        *dst = XT{};
      continue;
    }
    const XT* src = xb + static_cast<size_t>(c_s[l0 + l]) * p + j0 + q * V;
    if constexpr (kBytes == 0)
      *dst = *src;
    else
      cp_async<kBytes>(dst, src);
  }
}

template <int kThreads, int NT, typename XT>
__device__ __forceinline__ void stage_any(int copy_bytes, XT* xs,
                                          const XT* xb, const int* c_s,
                                          int l0, int l1, int j0, int jn,
                                          int p) {
  if (copy_bytes == 16)
    stage<kThreads, NT, 16>(xs, xb, c_s, l0, l1, j0, jn, p);
  else if (copy_bytes == 4)
    stage<kThreads, NT, 4>(xs, xb, c_s, l0, l1, j0, jn, p);
  else
    stage<kThreads, NT, 0>(xs, xb, c_s, l0, l1, j0, jn, p);
}

template <int kWarps, typename RowT, typename ColT, bool kBinary, int NT,
          typename XT>
__global__ void __launch_bounds__(32 * kWarps)
chunk_mxu_kernel(const int32_t* __restrict__ meta, int meta_ints,
                 const int32_t* __restrict__ n_valid,
                 const RowT* __restrict__ rows, const ColT* __restrict__ cols,
                 const float* __restrict__ vals,
                 const XT* __restrict__ x_pad, float* __restrict__ acc,
                 int C, int T, int p, int copy_bytes, int vec_out) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kLaneSlab = kThreads;
  constexpr int W = stride<NT>();
  const int g = blockIdx.x;
  // meta is read before n_valid is known (every launched chunk has a row),
  // so the two loads are in flight together
  const int32_t* m = meta + static_cast<size_t>(g) * meta_ints;
  const int tile_row = m[0];
  const int tile_col = m[1];
  const int nnz = max(min(m[3], C), 0);
  const int nv = __ldg(n_valid);
  if (g >= nv) return;
  float* ob = acc + static_cast<size_t>(tile_row) * T * p;
  const long long tile_elems = static_cast<long long>(T) * p;
  const int nb_row = neighbour_row(meta, meta_ints, g, nv);
  if (nnz == 0) {
    sweep_zero<kThreads>(nb_row, tile_row, ob, tile_elems, vec_out);
    return;
  }

  const int c_pad = (C + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  int* r_s = reinterpret_cast<int*>(smem);    // c_pad decoded rows
  int* c_s = r_s + c_pad;                     // c_pad decoded columns
  int* cid_s = c_s + c_pad;                   // c_pad compressed row ids
  int* start_s = cid_s + c_pad;               // c_pad + 16 run starts
  XT* xs = reinterpret_cast<XT*>(start_s + c_pad + 16);  // 2 slabs
  float* v_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(xs)
      + 2 * kLaneSlab * W * sizeof(float));   // 2 x kLaneSlab values

  const int warp = threadIdx.x >> 5;
  const int grp = (threadIdx.x & 31) >> 2;   // mma groupID
  const int tig = threadIdx.x & 3;           // mma thread-in-group
  const XT* xb = x_pad + static_cast<size_t>(tile_col) * T * p;
  const float* vg = kBinary ? nullptr : vals + static_cast<size_t>(g) * C;
  const int n_slabs = (nnz + kLaneSlab - 1) / kLaneSlab;
  const int n_steps = n_slabs * ((p + 8 * NT - 1) / (8 * NT));

  // step i: columns j0 = (i / n_slabs) * 8NT, lanes from (i % n_slabs) * slab
  auto issue = [&](int i) {
    const int j0 = (i / n_slabs) * 8 * NT;
    const int l0 = (i % n_slabs) * kLaneSlab;
    const int l1 = min(l0 + kLaneSlab, nnz);
    const int buf = i & 1;
    stage_any<kThreads, NT>(copy_bytes, xs + buf * kLaneSlab * W, xb, c_s,
                            l0, l1, j0, min(8 * NT, p - j0), p);
    for (int l = l0 + threadIdx.x; l < l1; l += kThreads)
      v_s[buf * kLaneSlab + l - l0] = kBinary ? 1.0f : vg[l];
    cp_async_commit();
  };

  decode_lanes<kThreads>(m, rows + static_cast<size_t>(g) * C,
                         cols + static_cast<size_t>(g) * C, C, T, nnz, r_s,
                         c_s);
  __syncthreads();
  issue(0);   // the first slab's gather overlaps the row compression
  sweep_zero<kThreads>(nb_row, tile_row, ob, tile_elems, vec_out);

  // -- 1. compressed row ids: a live lane opens a run where its row
  //       differs from the previous lane's --------------------------------
  int n_runs;
  {
    const int per = (nnz + kThreads - 1) / kThreads;
    const int lo = min(static_cast<int>(threadIdx.x) * per, nnz);
    const int hi = min(lo + per, nnz);
    int opens = 0;
    for (int i = lo; i < hi; ++i) opens += i == 0 || r_s[i] != r_s[i - 1];
    int k = block_exclusive_scan<kThreads>(opens, &n_runs) - 1;
    for (int i = lo; i < hi; ++i) {
      if (i == 0 || r_s[i] != r_s[i - 1]) start_s[++k] = i;
      cid_s[i] = k;
    }
    // lanes past nnz up to the next 16 match no compressed row
    for (int i = nnz + threadIdx.x; i < ((nnz + 15) & ~15); i += kThreads)
      cid_s[i] = -1;
    if (threadIdx.x == 0) start_s[n_runs] = nnz;
  }

  __syncthreads();   // compressed ids and run starts are in place
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // slab i is in shared memory

    const int j0 = (i / n_slabs) * 8 * NT;
    const int l0 = (i % n_slabs) * kLaneSlab;
    const int l1 = min(l0 + kLaneSlab, nnz);
    const XT* xsb = xs + (i & 1) * kLaneSlab * W;
    const float* vsb = v_s + (i & 1) * kLaneSlab;

    // -- 3. blk rows (16 compressed rows, 8NT columns) += E_r^T . S over
    //       the group's lanes in this slab --------------------------------
    const int q_end = cid_s[l1 - 1] / 16;
    for (int q = cid_s[l0] / 16 + warp; q <= q_end; q += kWarps) {
      const int k0 = 16 * q;
      const int k1 = min(k0 + 16, n_runs);
      const int a = max(start_s[k0], l0);
      const int b = min(start_s[k1], l1);
      // S = v (.) X[c], 0 on lanes past the slab's live ones
      auto term = [&](int l, int col) {
        return l >= l1 ? 0.0f : __fmul_rn(
            vsb[l - l0], to_float(xsb[(l - l0) * W + col]));
      };
      // d += E_r^T . S over the group's lanes; when careful, a term the
      // split cannot carry enters as 0, and the result says one did
      auto sweep = [&](float (&d)[NT][4], auto careful) {
        bool unfit = false;
        for (int k8 = a & ~7; k8 < b; k8 += 8) {
          const int la = k8 + tig;
          const int lb = la + 4;
          const int ca = cid_s[la] - k0;
          const int cb = cid_s[lb] - k0;
          const uint32_t af[4] = {
              ca == grp ? kOne : 0u, ca == grp + 8 ? kOne : 0u,
              cb == grp ? kOne : 0u, cb == grp + 8 ? kOne : 0u};
          #pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float sa = term(la, nt * 8 + grp);
            const float sb = term(lb, nt * 8 + grp);
            if constexpr (decltype(careful)::value) {
              const bool fa = tf32_splittable(sa);
              const bool fb = tf32_splittable(sb);
              unfit |= !(fa && fb);
              split_mma(d[nt], af, fa ? sa : 0.0f, fb ? sb : 0.0f);
            } else {
              split_mma(d[nt], af, sa, sb);
            }
          }
        }
        return unfit;
      };
      float d[NT][4] = {};
      sweep(d, std::false_type{});
      // A term the split cannot carry makes its whole column of d NaN or
      // inf (0 * inf in the one-hot product, inf - inf in the split), so a
      // finite sum of d means every term fitted (a finite sum that
      // overflows only costs the second pass); otherwise (rare) the group
      // is summed again with such terms routed around the mma.
      float total = 0.0f;
      #pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        total += (d[nt][0] + d[nt][1]) + (d[nt][2] + d[nt][3]);
      if (__any_sync(0xffffffffu, !isfinite(total))) {
        #pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          #pragma unroll
          for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
        if (sweep(d, std::true_type{})) route<NT>(term, a, b, r_s, ob, p, j0);
      }

      // -- 4. one reduction per compressed row and 4 columns: even threads
      //       of a quad take row grp, odd ones row grp + 8 ----------------
      const bool odd = tig & 1;
      const int k = k0 + grp + (odd ? 8 : 0);
      const bool live = k < k1 && start_s[k] < l1 && start_s[k + 1] > l0;
      const int t = live ? r_s[start_s[k]] : 0;
      #pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float o0 = __shfl_xor_sync(0xffffffffu,
                                         odd ? d[nt][0] : d[nt][2], 1);
        const float o1 = __shfl_xor_sync(0xffffffffu,
                                         odd ? d[nt][1] : d[nt][3], 1);
        const float v4[4] = {odd ? o0 : d[nt][0], odd ? o1 : d[nt][1],
                             odd ? d[nt][2] : o0, odd ? d[nt][3] : o1};
        const int col = j0 + nt * 8 + 4 * (tig >> 1);
        if (live && col < p)
          add4(ob + static_cast<size_t>(t) * p + col, v4, min(4, p - col),
               vec_out);
      }
    }
    __syncthreads();   // slab i's buffer is free for step i + 2
  }
}

// Dynamic shared memory of one block: the decoded lanes, compressed ids and
// run starts (16 bytes a lane), two X slabs and their values.
size_t smem_bytes(int C, int p, int warps) {
  const size_t c_pad = (static_cast<size_t>(C) + 15) & ~static_cast<size_t>(15);
  const int W = p <= 8 ? stride<1>() : stride<2>();
  return 4 * (4 * c_pad + 16)
         + 2 * 32 * warps * (static_cast<size_t>(W) + 1) * sizeof(float);
}

template <int kWarps, typename RowT, typename ColT, bool kBinary, int NT,
          typename XT>
cudaError_t launch_warps(const void* meta, int meta_ints, const void* n_valid,
                         const void* rows, const void* cols, const void* vals,
                         const void* x_pad, void* acc, int n_chunks, int C,
                         int T, int p, cudaStream_t stream) {
  auto kernel = chunk_mxu_kernel<kWarps, RowT, ColT, kBinary, NT, XT>;
  const size_t smem = smem_bytes(C, p, kWarps);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // Widest copy a gathered row allows: its bytes and X's base decide.
  const auto x_at = reinterpret_cast<uintptr_t>(x_pad);
  const size_t row_bytes = static_cast<size_t>(p) * sizeof(XT);
  const int copy_bytes = x_at % 16 == 0 && row_bytes % 16 == 0 ? 16
                         : x_at % 4 == 0 && row_bytes % 4 == 0 ? 4 : 0;
  const int vec_out = reinterpret_cast<uintptr_t>(acc) % 16 == 0 && p % 4 == 0;
  if (n_chunks > 0) {
    kernel<<<n_chunks, 32 * kWarps, smem, stream>>>(
        static_cast<const int32_t*>(meta), meta_ints,
        static_cast<const int32_t*>(n_valid), static_cast<const RowT*>(rows),
        static_cast<const ColT*>(cols), static_cast<const float*>(vals),
        static_cast<const XT*>(x_pad), static_cast<float*>(acc), C, T, p,
        copy_bytes, vec_out);
  }
  return cudaGetLastError();
}

// Warps a chunk, from the launch's chunk count: four while the launch's
// chunks all fit on the card at once, so each finishes soonest; one past
// kManyChunks, so four times as many are in flight (on the densify cell a
// 256-chunk batch took 0.0085 ms with four warps a chunk and 0.020 with
// one, the whole matrix 1.39 ms with four and 1.02 with one: PERF.md,
// kernels/tune_densify.py).
template <typename RowT, typename ColT, bool kBinary, int NT, typename XT>
cudaError_t launch(const void* meta, int meta_ints, const void* n_valid,
                   const void* rows, const void* cols, const void* vals,
                   const void* x_pad, void* acc, int n_chunks, int C, int T,
                   int p, cudaStream_t stream) {
  if (n_chunks > kManyChunks)
    return launch_warps<kWarpsMany, RowT, ColT, kBinary, NT, XT>(
        meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C,
        T, p, stream);
  return launch_warps<kWarpsFew, RowT, ColT, kBinary, NT, XT>(
      meta, meta_ints, n_valid, rows, cols, vals, x_pad, acc, n_chunks, C, T,
      p, stream);
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
