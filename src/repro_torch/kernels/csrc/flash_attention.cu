// Forward flash attention (GQA, causal or not, optional tanh softcap) for
// sm_90a, its two products on the tensor cores (wgmma) at float32 accuracy.
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_tpu (body _flash_body).
//
// Contract: q (B, L, H, hd), k and v (B, S, KV, hd), H = KV*G, hd <= 128,
// float32 or bfloat16, contiguous; out (B, L, H, hd) in q's type.  Query
// head h reads key/value head h / G.  For each query row:
//   s_j = (q * scale) . k_j          scale = 1/sqrt(hd), q scaled first
//   s_j = tanh(s_j / cap) * cap      when cap > 0
//   s_j = -1e30 where key j > query row (causal) or j >= S
//   out = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
// with the running max m and sums kept online over key tiles in float32,
// as the Pallas body does (NEG_INF = -1e30, not -inf, so a masked score
// underflows to 0 against any real one).  Causal positions are each row's
// query index against the key index, with no offset, as in the Pallas body.
//
// Design.  A block of kWarps = 8 warps (two warpgroups) takes 16*kWarps
// query rows of one head and batch; each warp owns 16 rows, and everything
// of a row stays in its warp's registers.  The grid is one dimension,
// heaviest query blocks first when causal, so the short ones fill the tail.
//   * Products.  S = Q K^T and O += P V run as wgmma.mma_async m64nNk8 TF32
//     (A from registers, B from shared memory) with the three-term split of
//     tf32_mma.cuh (a_hi b_hi + a_hi b_lo + a_lo b_hi): float32 accuracy at
//     a third of the TF32 rate.  The scaled Q is split once into hi/lo A
//     fragments held in registers; P is split as its fragments are formed;
//     each staged K and V tile is split once, by the whole block, into hi
//     and lo planes laid out as wgmma's core matrices (8 rows of 16 bytes,
//     no swizzle: LBO 128 bytes to the next 4 columns of k, SBO 256 bytes to
//     the next 8 rows of n).  hd is padded with zeros to HDP, the next
//     multiple of 8 (14 k-steps at hd = 112, none wasted).
//   * Fragment order.  Both products sum over an index (d in Q K^T, the key
//     in P V) whose order within a k-step of 8 is free, as long as both
//     factors use the same one.  Column t of a k-step is taken as index 2t,
//     column t + 4 as 2t + 1 (the planes store them so).  Then the m64nN C
//     fragment of S, which holds keys 2t and 2t + 1 of rows g and g + 8, is
//     already P's A fragment for P V: no shuffle, no shared memory.
//   * Softmax in registers, on the C fragments: a row's scores live in one
//     quad, so its max and sum take two __shfl_xor_sync steps.  expf, as the
//     plain version's torch.exp.  The mask is applied only on key tiles that
//     cross a warp's diagonal or the end of S; tiles wholly in a warpgroup's
//     future are skipped (and not staged when in the whole block's).
//   * Staging.  K and V tiles of kKeys rows go to shared memory by 16-byte
//     cp.async (4-byte where hd is not a multiple of 4 or a base is not
//     16-byte aligned): tile t + 1 is in flight while tile t is multiplied.
//     Rows past S are zero-filled by the copy; the pad columns are zeroed
//     once.  bfloat16 inputs are widened by plain loads into the same
//     float32 tiles.  Two block barriers a tile: the raw tile is in, the
//     split planes are in.
//   The block shape (8 warps, 32 keys a tile) and the alternatives are timed
//   by kernels/tune_flash.py.  At hd = 112 the float32 kernel holds 249
//   registers a thread, 112 of them Q's split fragments; keeping the next
//   tile's split or P V in flight across tiles needed more and spilled.
//
// Bound on this card: operations.  Causal attention needs 4*B*H*hd*L(L+1)/2
// float32 flops (two products) over 16*B*L*H*hd bytes: at L = 2048, hd =
// 112 some 570 flops a byte.  On the CUDA cores (67 TFLOP/s) that is 0.898
// ms at the Zamba2-7B prefill's shape; at float32 accuracy on the tensor
// cores, three TF32 products over 495 TFLOP/s, 0.365 ms.
//
// Host entry point: plain C interface (ctypes), launches on the given
// stream, allocates nothing, returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;                  // warps a block, 16 query rows each
constexpr int kKeys = 32;                  // keys a staged tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;         // query rows a block

// Shared memory of a block: the raw K and V tiles (kKeys x hdp floats each,
// as staged), then the split planes K hi, K lo, V hi, V lo (kKeys x hdp
// words each, see split_k and split_v).
__host__ __device__ constexpr size_t smem_bytes(int hdp) {
  return 6 * static_cast<size_t>(kKeys) * hdp * sizeof(float);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [k0, k0 + kKeys) of one K or V head (row j at src + j * ld_src) into
// a shared tile of row stride LD, columns [0, hd): cp.async, 16 bytes a copy
// when vec, else 4; rows at or past S are zero-filled.
template <int LD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      size_t ld_src, int k0, int S, int hd,
                                      bool vec) {
  const int w = vec ? 4 : 1;
  const int per = hd / w;
  for (int e = threadIdx.x; e < kKeys * per; e += kThreads) {
    const int r = e / per;
    const int c = (e - r * per) * w;
    const bool in = k0 + r < S;
    const float* from = src + (in ? (k0 + r) * ld_src + c : 0);
    if (vec)
      cp_async<16>(dst + r * LD + c, from, in ? 16 : 0);
    else
      cp_async<4>(dst + r * LD + c, from, in ? 4 : 0);
  }
}

// The same for bfloat16 inputs, widened by plain loads.
template <int LD>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      size_t ld_src, int k0, int S, int hd,
                                      bool) {
  for (int e = threadIdx.x; e < kKeys * hd; e += kThreads) {
    const int r = e / hd;
    const int c = e - r * hd;
    dst[r * LD + c] = k0 + r < S
        ? __bfloat162float(src[(k0 + r) * ld_src + c]) : 0.0f;
  }
}

// d0, d1 (the m64n16 accumulator: columns 0-7 and 8-15) += A (m64k8, this
// warp's 16 rows in registers, the m16n8k8 A fragment) . B (k8n16 at b).
__device__ __forceinline__ void wgmma16(float (&d0)[4], float (&d1)[4],
                                        const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d1[0]),
        "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// The same for an m64n8 accumulator (an odd n-tile at the end).
__device__ __forceinline__ void wgmma8(float (&d0)[4], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..NT) += a . B over NT n-tiles of 8, B's k-step at plane base p
// (core-matrix groups of 8 rows SBO apart)
template <int NT>
__device__ __forceinline__ void wgmma_row(float (&d)[NT][4],
                                          const uint32_t (&a)[4],
                                          const uint32_t* p) {
#pragma unroll
  for (int c = 0; c + 1 < NT; c += 2)
    wgmma16(d[c], d[c + 1], a, wgmma_desc(p + c * 64));
  if constexpr (NT % 2) wgmma8(d[NT - 1], a, wgmma_desc(p + (NT - 1) * 64));
}

// The raw K tile split into hi and lo planes, each the B operand of S = Q K^T
// (n = key, k = d): k-step kk is kKeys x 8 words at kk * 8 * kKeys; in it,
// keys 8c .. 8c + 7 form core matrices at 64c words (kSBO), d = 8kk + dd
// sits at column dd >> 1 of the half dd & 1 (kLBO), so column t of a
// k-step holds d 2t and column t + 4 holds 2t + 1 (the header's order).
// A thread splits 8 d of one key: two 16-byte stores a plane.
template <int HDP>
__device__ __forceinline__ void split_k(uint32_t* hi, uint32_t* lo,
                                        const float* raw) {
  constexpr int KS = HDP / 8;
  for (int e = threadIdx.x; e < kKeys * KS; e += kThreads) {
    const int key = e % kKeys;
    const int kk = e / kKeys;
    const float4 x0 = *reinterpret_cast<const float4*>(
        raw + key * HDP + 8 * kk);
    const float4 x1 = *reinterpret_cast<const float4*>(
        raw + key * HDP + 8 * kk + 4);
    uint4 h0, l0, h1, l1;
    split_tf32(x0.x, h0.x, l0.x);
    split_tf32(x0.y, h1.x, l1.x);
    split_tf32(x0.z, h0.y, l0.y);
    split_tf32(x0.w, h1.y, l1.y);
    split_tf32(x1.x, h0.z, l0.z);
    split_tf32(x1.y, h1.z, l1.z);
    split_tf32(x1.z, h0.w, l0.w);
    split_tf32(x1.w, h1.w, l1.w);
    const int off = kk * kKeys * 8 + (key >> 3) * 64 + (key & 7) * 4;
    *reinterpret_cast<uint4*>(hi + off) = h0;
    *reinterpret_cast<uint4*>(hi + off + 32) = h1;
    *reinterpret_cast<uint4*>(lo + off) = l0;
    *reinterpret_cast<uint4*>(lo + off + 32) = l1;
  }
}

// The raw V tile split likewise, each plane the B operand of O += P V
// (n = d, k = key): k-step j (keys 8j .. 8j + 7) is HDP x 8 words at
// j * 8 * HDP; d 8c .. 8c + 7 form core matrices at 64c words, key 8j + kk
// at column kk >> 1 of the half kk & 1.  A thread splits 4 keys of one d
// (8j + half + 2e, e < 4): one 16-byte store a plane.
template <int HDP>
__device__ __forceinline__ void split_v(uint32_t* hi, uint32_t* lo,
                                        const float* raw) {
  for (int e = threadIdx.x; e < kKeys * HDP / 4; e += kThreads) {
    const int d = e % HDP;
    const int jh = e / HDP;               // 2j + half
    const int key0 = 8 * (jh >> 1) + (jh & 1);
    uint4 hv, lv;
    split_tf32(raw[(key0 + 0) * HDP + d], hv.x, lv.x);
    split_tf32(raw[(key0 + 2) * HDP + d], hv.y, lv.y);
    split_tf32(raw[(key0 + 4) * HDP + d], hv.z, lv.z);
    split_tf32(raw[(key0 + 6) * HDP + d], hv.w, lv.w);
    const int off = (jh >> 1) * HDP * 8 + (d >> 3) * 64 + (jh & 1) * 32
                    + (d & 7) * 4;
    *reinterpret_cast<uint4*>(hi + off) = hv;
    *reinterpret_cast<uint4*>(lo + off) = lv;
  }
}

template <int KS, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int B, int L,
                 int S, int H, int KV, int hd, int causal, float softcap,
                 float scale, int vec) {
  constexpr int HDP = 8 * KS;
  constexpr int NS = kKeys / 8;      // n-tiles of S, k-steps of P V
  constexpr int kPlane = kKeys * HDP;
  extern __shared__ __align__(16) float smem[];
  float* k_raw = smem;                           // kKeys x HDP, as staged
  float* v_raw = k_raw + kPlane;
  uint32_t* kh_s = reinterpret_cast<uint32_t*>(v_raw + kPlane);
  uint32_t* kl_s = kh_s + kPlane;
  uint32_t* vh_s = kl_s + kPlane;
  uint32_t* vl_s = vh_s + kPlane;

  const int hb = blockIdx.x % (H * B);
  int qb = blockIdx.x / (H * B);
  if (causal) qb = (L + kRows - 1) / kRows - 1 - qb;   // heaviest first
  const int h = hb % H;
  const int b = hb / H;
  const int q0 = qb * kRows;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;     // fragment groupID
  const int t = threadIdx.x & 3;             // fragment thread-in-group
  const int r0 = q0 + 16 * warp;             // the warp's first query row
  const int wg_last = q0 + 64 * (warp >> 2) + 63;   // the warpgroup's last row
  const size_t ld_kv = static_cast<size_t>(KV) * hd;
  const T* kb = k + (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const T* vb = v + (static_cast<size_t>(b) * S * KV + kvh) * hd;

  // the pad columns [hd, HDP) of the raw tiles, never written again
  for (int e = threadIdx.x; e < 2 * kKeys * (HDP - hd); e += kThreads) {
    const int r = e / (HDP - hd);
    k_raw[r * HDP + hd + e - r * (HDP - hd)] = 0.0f;   // K's rows, then V's
  }

  const int n_tiles = (S + kKeys - 1) / kKeys;
  const int last = causal ? min(n_tiles, (q0 + kRows + kKeys - 1) / kKeys)
                          : n_tiles;
  auto issue = [&](int tile) {
    stage<HDP>(k_raw, kb, ld_kv, tile * kKeys, S, hd, vec);
    stage<HDP>(v_raw, vb, ld_kv, tile * kKeys, S, hd, vec);
    cp_async_commit();
  };
  if (last > 0) issue(0);

  // Q (scaled) as split A fragments: a[i] is row g + 8*(i & 1), index
  // 2t + (i >> 1) of each k-step (see the header, fragment order)
  uint32_t qh[KS][4], ql[KS][4];
  {
    const T* qr = q + (static_cast<size_t>(b) * L * H + h) * hd;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i & 1);
        const int d = 8 * kk + 2 * t + (i >> 1);
        const float x = row < L && d < hd
            ? widen(qr[static_cast<size_t>(row) * H * hd + d]) * scale
            : 0.0f;
        split_tf32(x, qh[kk][i], ql[kk][i]);
      }
  }

  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int tile = 0; tile < last; ++tile) {
    cp_async_wait<0>();
    __syncthreads();   // the raw tiles are in; every warp is done with tile - 1
    split_k<HDP>(kh_s, kl_s, k_raw);
    split_v<HDP>(vh_s, vl_s, v_raw);
    // the planes' stores, made by the generic proxy, visible to wgmma's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // the planes are in place; the raw tiles are free
    if (tile + 1 < last) issue(tile + 1);
    const int k0 = tile * kKeys;
    if (causal && k0 > wg_last) continue;   // wholly in the warpgroup's future

    // S = Q K^T: s[j][e] is row g + 8*(e >> 1), key k0 + 8j + 2t + (e & 1)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_row<NS>(s, qh[kk], kh_s + kk * kKeys * 8);
      wgmma_row<NS>(s, qh[kk], kl_s + kk * kKeys * 8);
      wgmma_row<NS>(s, ql[kk], kh_s + kk * kKeys * 8);
    }
    wg_commit();
    wg_wait();
    reg_fence(s);

    // online softmax over the tile, rows g and g + 8 of the warp
    const bool masked = (causal && k0 + kKeys - 1 > r0) || k0 + kKeys > S;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        if (masked) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          if (key >= S || (causal && key > row)) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);            // the new running max
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      const float corr = expf(m[r] - mx[r]);
      l[r] = l[r] * corr + sum[r];
      m[r] = mx[r];
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }

    // O += P V: P's A fragment is S's C fragment (keys 2t, 2t + 1 as
    // columns t, t + 4, the order the V planes store)
    uint32_t ph[NS][4], pl[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      split_tf32(s[j][0], ph[j][0], pl[j][0]);
      split_tf32(s[j][2], ph[j][1], pl[j][1]);
      split_tf32(s[j][1], ph[j][2], pl[j][2]);
      split_tf32(s[j][3], ph[j][3], pl[j][3]);
    }
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      wgmma_row<KS>(o, ph[j], vh_s + j * HDP * 8);
      wgmma_row<KS>(o, ph[j], vl_s + j * HDP * 8);
      wgmma_row<KS>(o, pl[j], vh_s + j * HDP * 8);
    }
    wg_commit();
    wg_wait();
    reg_fence(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= L) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* dst = out + ((static_cast<size_t>(b) * L + row) * H + h) * hd;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < hd) narrow(dst + d, o[n][2 * r] / den);
      if (d + 1 < hd) narrow(dst + d + 1, o[n][2 * r + 1] / den);
    }
  }
}

template <int KS, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int L, int S, int H, int KV, int hd, int causal,
                   float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(8 * KS);
  auto kernel = flash_fwd_kernel<KS, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = hd % 4 == 0 && aligned(k) && aligned(v);
  const long long blocks = static_cast<long long>((L + kRows - 1) / kRows)
                           * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0) {
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), B, L, S, H, KV,
        hd, causal, softcap, scale, vec);
  }
  return cudaGetLastError();
}

// hd padded to the next multiple of 8: KS = HDP / 8 k-steps.
template <typename T, int KS = 1>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int L, int S, int H, int KV, int hd, int causal,
                      float softcap, float scale, cudaStream_t stream) {
  if constexpr (KS < 16) {
    if (hd > 8 * KS)
      return launch_hd<T, KS + 1>(q, k, v, out, B, L, S, H, KV, hd, causal,
                                  softcap, scale, stream);
  }
  return launch<KS, T>(q, k, v, out, B, L, S, H, KV, hd, causal, softcap,
                       scale, stream);
}

}  // namespace

// out (B, L, H, hd) = attention(q, k, v); bf16 != 0 marks bfloat16 tensors
// (float32 otherwise).  Takes hd <= 128 and H a multiple of KV.  Returns a
// cudaError_t; cudaErrorInvalidValue for shapes it does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int L,
                                   int S, int H, int KV, int hd, int causal,
                                   float softcap, float scale, int bf16,
                                   void* stream) {
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch_hd<__nv_bfloat16>(
        q, k, v, out, B, L, S, H, KV, hd, causal, softcap, scale, s));
  return static_cast<int>(launch_hd<float>(q, k, v, out, B, L, S, H, KV, hd,
                                           causal, softcap, scale, s));
}
