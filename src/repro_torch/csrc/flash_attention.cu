// Causal + sliding-window GQA attention with an online softmax,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (B4, :83; _kernel :28).  For each
// (b, query head h) with KV head g = h / n_rep:
//     o_i = Σ_j softmax_j(q_i·k_j · hd^-0.5) · v_j
// over the keys j < sk with, when causal, j <= i and (window > 0) i − j <
// window (query and key positions both count from 0).  q (B, H, Sq, hd),
// k and v (B, KV, Sk, hd), all one dtype (f32 or bf16); scores, softmax and
// the product with v in f32; the output (B, H, Sq, hd) in q's dtype.
// Masked scores are −1e30, as the TPU kernel's, so a row whose keys in a
// visited tile are all masked behaves as there; keys past sk (a ragged
// last tile) are −inf and never count.
//
// What bounds it: f32 operations.  At zamba2-2.7b's shared attention
// (2 × 32 heads, hd 80, S 2048, causal) the band below the diagonal is
// 43 GFLOP, 0.64 ms at 67 TFLOP/s, against 84 MB of bf16 q, k, v and
// output (0.03 ms at 3.35 TB/s).  The design keeps every score on chip:
//   * one block of 256 threads per (64-query tile, head, batch row); the
//     tiles with the most keys launch first (blockIdx.x counts down);
//   * q·scale (f32, transposed) stays in shared memory; K tiles of 64
//     keys stream through one shared buffer, transposed, then V through
//     the same buffer; tiles wholly above the diagonal or before the
//     window are never loaded;
//   * a thread computes a 4 × 4 patch of the 64 × 64 score tile (two
//     float4 loads per 16 fused multiply-adds), the 16 threads of a row
//     group reduce max and sum with shuffles, and it keeps 4 rows × hd/16
//     columns (d = tx + 16·e) of the f32 output accumulator in registers;
//   * p goes through shared memory (transposed) to the P·V product.
// Head dims 32, 64, 80, 96, 128 and 256 are compiled (hd/16 columns a
// thread); any S, with masked ragged tiles.  wgmma, TMA and bf16 operands
// on the tensor cores come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64, kBk = 64;   // query rows and keys of a tile
constexpr int kThreads = 256;       // 16 × 16: ty over rows, tx over keys
constexpr int kLd = kBq + 4;        // leading dim of Qᵀ, Kᵀ and Pᵀ (floats)
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
static_assert(kBq == kBk, "Qt, Kt and Pt share one leading dimension");

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Qᵀ [HD][kLd], the K / V buffer (Kᵀ [HD][kLd] or V [kBk][HD]), Pᵀ
  return (2 * HD * kLd + kBk * kLd) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int n_heads,
                 int kv_heads, int sq, int sk, int causal, int window,
                 float scale) {
  static_assert(HD % 16 == 0, "a thread owns hd/16 output columns");
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [HD][kLd]  q·scale, transposed
  float* kv = qt + HD * kLd;        // Kᵀ [HD][kLd], then V [kBk][HD]
  float* pt = kv + HD * kLd;        // Pᵀ [kBk][kLd]

  const int qi = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (n_heads / kv_heads);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qi * kBq;
  const T* qb = q + (static_cast<int64_t>(b) * n_heads + h) * sq * HD;
  const T* kb = k + (static_cast<int64_t>(b) * kv_heads + g) * sk * HD;
  const T* vb = v + (static_cast<int64_t>(b) * kv_heads + g) * sk * HD;
  T* ob = out + (static_cast<int64_t>(b) * n_heads + h) * sq * HD;

  for (int e = tid; e < kBq * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, row = q0 + r;
    qt[d * kLd + r] =
        row < sq ? load_f32(qb, static_cast<int64_t>(row) * HD + d) * scale
                 : 0.f;
  }

  // the key tiles some row of this query tile attends to
  int kt_lo = 0, kt_hi = (sk + kBk - 1) / kBk - 1;
  if (causal) {
    kt_hi = min(kt_hi, (q0 + kBq - 1) / kBk);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBk;
  }

  float o[4][kCols], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();   // Qᵀ is written; the last tile's V and Pᵀ are read
    for (int e = tid; e < kBk * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, key = k0 + r;
      kv[d * kLd + r] =
          key < sk ? load_f32(kb, static_cast<int64_t>(key) * HD + d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kv + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, then the online softmax of each of the thread's four rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        if (key >= sk)
          s[i][j] = -INFINITY;
        else if (causal && (key > row || (window > 0 && row - key >= window)))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
    }

    __syncthreads();   // every thread is done with Kᵀ
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    for (int e = tid; e < kBk * HD; e += kThreads) {
      const int key = k0 + e / HD;
      kv[e] = key < sk ? load_f32(vb, static_cast<int64_t>(k0) * HD + e)
                       : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(pt + j * kLd + ty * 4);
      const float* vrow = kv + j * HD + tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vrow[16 * c];
        o[0][c] = fmaf(a.x, vv, o[0][c]);
        o[1][c] = fmaf(a.y, vv, o[1][c]);
        o[2][c] = fmaf(a.z, vv, o[2][c]);
        o[3][c] = fmaf(a.w, vv, o[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < sq) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        store(ob + static_cast<int64_t>(row) * HD + tx + 16 * c,
              o[i][c] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int kv, int sq, int sk, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB a block's dynamic shared memory needs this opt-in (it
  // holds for the current device, so it is set at every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBq - 1) / kBq, h, b);
  attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), h, kv, sq, sk, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int h, int kv, int sq, int sk, int hd, int causal, int window,
             float scale, cudaStream_t stream) {
#define REPRO_ATTN(HH)                                                      \
  case HH:                                                                  \
    return launch<T, HH>(q, k, v, out, b, h, kv, sq, sk, causal, window,    \
                         scale, stream)
  switch (hd) {
    REPRO_ATTN(32);
    REPRO_ATTN(64);
    REPRO_ATTN(80);
    REPRO_ATTN(96);
    REPRO_ATTN(128);
    REPRO_ATTN(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_ATTN
}

}  // namespace

// q and out (b, h, sq, hd), k and v (b, kv, sk, hd), one dtype (1 = bf16,
// 0 = f32).  hd in {32, 64, 80, 96, 128, 256}; h a multiple of kv.
// Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int h,
                                     int kv, int sq, int sk, int hd,
                                     int causal, int window, float scale,
                                     int bf16, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kv < 1 || h % kv != 0 ||
      sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, b, h, kv, sq, sk, hd,
                                        causal, window, scale, s)
              : dispatch<float>(q, k, v, out, b, h, kv, sq, sk, hd, causal,
                                window, scale, s);
}
