// Forward flash attention (GQA, causal or not, optional tanh softcap) for
// sm_90a, in float32 on the CUDA cores.
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_tpu (body _flash_body).
//
// Contract: q (B, L, H, hd), k and v (B, S, KV, hd), H = KV*G, float32 or
// bfloat16, contiguous; out (B, L, H, hd) in q's type.  Query head h reads
// key/value head h / G.  For each query row:
//   s_j = (q * scale) . k_j          scale = 1/sqrt(hd), q scaled first
//   s_j = tanh(s_j / cap) * cap      when cap > 0
//   s_j = -1e30 where key j > query row (causal) or j >= S
//   out = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
// with the running max m and sums kept online over key tiles in float32,
// as the Pallas body does (NEG_INF = -1e30, not -inf, so a masked score
// underflows to 0 against any real one).  Causal positions are each row's
// query index against the key index, with no offset, as in the Pallas body.
// Key tiles wholly in the future of a query tile are skipped.
//
// Design, correctness first.  One block of 256 threads per (64 query rows,
// head, batch): grid (ceil(L/64), H, B).  The Q tile (scaled) stays in
// shared memory; each 64-key tile of K and V is staged there, widened to
// float32; S = Q K^T and O += P V are float32 FMA tile products
// (tile_fma.cuh), the scores of a row spread over 16 threads that reduce
// their row's max and sum with warp shuffles.  The head dimension is padded
// to HDP in {32, 64, 128} with zeros, so any hd <= 128 works (hd = 112 for
// Zamba2-7B).  Not folding the G query heads of a KV head into one tile
// costs G reads of each K/V tile; at G = 1 (Zamba2-7B) it costs nothing.
// Float32 FMA keeps the reference's float32 tolerance (2e-4); a single TF32
// tensor-core product would not.
//
// Bound on this card: operations.  Causal attention does 4*B*H*hd*L(L+1)/2
// float32 flops (two products) over 16*B*L*H*hd bytes: at L = 2048, hd =
// 112 some 570 flops a byte, far above the 20 of the float32 ridge (67
// TFLOP/s over 3.35 TB/s).  A faster design stages tiles with TMA, runs the
// two products as wgmma (bf16, or a split TF32 for float32 accuracy) with
// the softmax in registers, and folds the G query heads into the rows.
//
// Host entry point: plain C interface (ctypes), launches on the given
// stream, allocates nothing, returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_fma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kKeys = 64;                         // keys per tile
constexpr int kLdP = row_stride(kKeys);

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A (rows x HDP) tile of a (B, len, heads, hd) tensor into shared memory,
// rows [row0, row0 + 64) of head `head`, float32, zero past len and hd.
template <int HDP, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int b, int row0, int len, int heads,
                                      int head, int hd, float mul) {
  for (int e = threadIdx.x; e < kTileRows * HDP; e += kTileThreads) {
    const int r = e / HDP;
    const int d = e - r * HDP;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < len && d < hd)
      v = widen(src[((static_cast<size_t>(b) * len + row) * heads + head)
                    * hd + d]) * mul;
    dst[r * ld + d] = v;
  }
}

template <int HDP, typename T>
__global__ void __launch_bounds__(kTileThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int L, int S,
                 int H, int KV, int hd, int causal, float softcap,
                 float scale) {
  constexpr int kLdQ = row_stride(HDP);
  constexpr int kNJ = HDP / 16;                   // output column groups
  constexpr int kKP = kTileRows * (kLdQ > kLdP ? kLdQ : kLdP);
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                              // 64 x kLdQ
  float* kp_s = q_s + kTileRows * kLdQ;           // K tile, then P tile
  float* v_s = kp_s + kKP;                        // 64 x HDP

  const int q0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15;
  const int r0 = (threadIdx.x >> 4) * 4;

  stage<HDP>(q_s, kLdQ, q, b, q0, L, H, h, hd, scale);

  float m[4], l[4], o[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) o[i][j] = 0.0f;
  }

  const int n_tiles = (S + kKeys - 1) / kKeys;
  const int last = causal ? min(n_tiles, (q0 + kTileRows + kKeys - 1) / kKeys)
                          : n_tiles;
  for (int t = 0; t < last; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();          // the previous tile's P and V are consumed
    stage<HDP>(kp_s, kLdQ, k, b, k0, S, KV, kvh, hd, 1.0f);
    stage<HDP>(v_s, HDP, v, b, k0, S, KV, kvh, hd, 1.0f);
    __syncthreads();

    float s[4][4] = {};
    fma_abt<4>(s, q_s, kLdQ, kp_s, kLdQ, HDP, r0, tx);
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) o[i][j] *= corr[i];
    }
    __syncthreads();          // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kp_s[(r0 + i) * kLdP + tx + 16 * j] = s[i][j];
    __syncthreads();
    fma_ab<kNJ>(o, kp_s, kLdP, v_s, HDP, kKeys, r0, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= L) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = out + ((static_cast<size_t>(b) * L + row) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) narrow(dst + d, o[i][j] / den);
    }
  }
}

template <int HDP, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int L, int S, int H, int KV, int hd, int causal,
                   float softcap, float scale, cudaStream_t stream) {
  constexpr int kLdQ = row_stride(HDP);
  constexpr int kKP = kTileRows * (kLdQ > kLdP ? kLdQ : kLdP);
  const size_t smem = sizeof(float) * (kTileRows * kLdQ + kKP
                                       + kTileRows * HDP);
  auto kernel = flash_fwd_kernel<HDP, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (B > 0 && L > 0 && H > 0) {
    const dim3 grid((L + kTileRows - 1) / kTileRows, H, B);
    kernel<<<grid, kTileThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), L, S, H, KV, hd,
        causal, softcap, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int L, int S, int H, int KV, int hd, int causal,
                      float softcap, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<32, T>(q, k, v, out, B, L, S, H, KV, hd, causal, softcap,
                         scale, stream);
  if (hd <= 64)
    return launch<64, T>(q, k, v, out, B, L, S, H, KV, hd, causal, softcap,
                         scale, stream);
  return launch<128, T>(q, k, v, out, B, L, S, H, KV, hd, causal, softcap,
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
