// The Mamba2 SSD scan from a zero state, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mamba_ssd_scan of
// src/repro/kernels/mamba_scan.py (B7, :63; _kernel :24).  Per (b, h),
// with a = −exp(A_log[h]) and the (P, N) state H starting at zero, for
// t = 0 .. seq − 1:
//     H[p][n] = H[p][n] · exp(dt_t · a) + dt_t · x_t[p] · B_t[n]
//     y_t[p]  = Σ_n H[p][n] · C_t[n] + D[h] · x_t[p]
// x (Bt, H, S, P) and B, C (Bt, S, N) (single group) in f32 or bf16 (one
// dtype), dt (Bt, H, S), A_log and D (H,) f32; math in f32, y (Bt, H, S, P)
// in x's dtype.
//
// The TPU kernel computes this through the chunked SSD decomposition
// (intra-chunk (C·Bᵀ ⊙ decay) @ (dt·x), inter-chunk C @ Hᵀ, a state update
// per chunk), which exists to feed the MXU: at zamba2-2.7b's chunk of 256
// it spends about 27 GFLOP a prefill layer, where the recurrence above
// spends 5·P·N per step, 6.7 GFLOP.  Without tensor cores the recurrence
// is the cheaper form, and it needs no Q × Q decay tile (256 KB in f32 at
// Q = 256), no exp of a cumulative sum that overflows above the diagonal
// and no divisibility of S by the chunk: ``chunk`` does not change the
// math here, only the float order of the XLA and TPU forms.
//
// What bounds it: f32 operations (6.7 GFLOP, 0.1 ms at 67 TFLOP/s,
// against 85 MB of bf16 input and output, 0.03 ms at 3.35 TB/s), under a
// chain of seq dependent steps.  The rows p of the state are independent
// (they share only dt, B and C), so the grid is (P / 32, H, Bt) blocks of
// 128 threads — 320 blocks at zamba2's 2 × 80 heads — and each block:
//   * keeps its 32 × N slice of the state in registers: a thread owns 2
//     rows × N/8 columns, and 8 threads per row pair sum y with shuffles;
//   * stages kSteps steps of x (its 32 rows), dt, exp(dt·a), B and C in
//     shared memory (B and C read as float4 where N/8 allows), fetching the
//     next kSteps into registers while the current ones run.
// Each step uses fused multiply-adds where the reference rounds twice;
// the tolerance of the tests says so.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = 8;       // threads sharing one row pair's N columns
constexpr int kRowsPer = 2;      // state rows a thread owns
constexpr int kTileP = kThreads / kGroups * kRowsPer;   // rows of P a block owns
constexpr int kSteps = 32;       // steps staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ B,
           const T* __restrict__ C, const float* __restrict__ d_skip,
           T* __restrict__ y, int n_heads, int seq, int p_dim) {
  constexpr int kCols = N / kGroups;                  // state columns a thread owns
  constexpr int kPerBC = kSteps * N / kThreads;       // staged B (and C) per thread
  constexpr int kPerX = kSteps * kTileP / kThreads;   // staged x per thread
  __shared__ __align__(16) float bs[kSteps * N];
  __shared__ __align__(16) float cs[kSteps * N];
  __shared__ float xs[kSteps * kTileP];
  __shared__ float dts[kSteps], als[kSteps];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, g = tid % kGroups, pr = tid / kGroups;
  const int p0 = tile * kTileP;
  const int64_t bh = static_cast<int64_t>(b) * n_heads + h;
  const T* xb = x + bh * seq * p_dim;
  T* yb = y + bh * seq * p_dim;
  const float* dtb = dt + bh * seq;
  const int64_t n_bc = static_cast<int64_t>(seq) * N;
  const T* bb = B + static_cast<int64_t>(b) * n_bc;
  const T* cb = C + static_cast<int64_t>(b) * n_bc;
  const float a = -expf(a_log[h]);
  const float dsk = d_skip[h];

  float st[kRowsPer][kCols];
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j)
#pragma unroll
    for (int i = 0; i < kCols; ++i) st[j][i] = 0.f;

  // the next stage, fetched into registers
  float pb[kPerBC], pc[kPerBC], px[kPerX], pdt = 0.f;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kPerBC; ++j) {
      const int64_t i = static_cast<int64_t>(t0) * N + tid + j * kThreads;
      pb[j] = i < n_bc ? to_f32(bb[i]) : 0.f;
      pc[j] = i < n_bc ? to_f32(cb[i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPerX; ++j) {
      const int e = tid + j * kThreads;
      const int t = t0 + e / kTileP, p = p0 + e % kTileP;
      px[j] = t < seq && p < p_dim
                  ? to_f32(xb[static_cast<int64_t>(t) * p_dim + p]) : 0.f;
    }
    if (tid < kSteps) pdt = t0 + tid < seq ? dtb[t0 + tid] : 0.f;
  };
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < kPerBC; ++j) {
      bs[tid + j * kThreads] = pb[j];
      cs[tid + j * kThreads] = pc[j];
    }
#pragma unroll
    for (int j = 0; j < kPerX; ++j) xs[tid + j * kThreads] = px[j];
    if (tid < kSteps) {
      dts[tid] = pdt;
      als[tid] = expf(pdt * a);
    }
  };

  fetch(0);
  put();
  __syncthreads();
  for (int t0 = 0; t0 < seq; t0 += kSteps) {
    const bool more = t0 + kSteps < seq;
    if (more) fetch(t0 + kSteps);
    const int n = min(kSteps, seq - t0);
    for (int t = 0; t < n; ++t) {
      const float al = als[t], dtv = dts[t];
      float bv[kCols], cv[kCols];
      const float* brow = bs + t * N + g * kCols;
      const float* crow = cs + t * N + g * kCols;
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int i = 0; i < kCols; i += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(brow + i);
          const float4 c4 = *reinterpret_cast<const float4*>(crow + i);
          bv[i] = b4.x; bv[i + 1] = b4.y; bv[i + 2] = b4.z; bv[i + 3] = b4.w;
          cv[i] = c4.x; cv[i + 1] = c4.y; cv[i + 2] = c4.z; cv[i + 3] = c4.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          bv[i] = brow[i];
          cv[i] = crow[i];
        }
      }
      float xv[kRowsPer], yv[kRowsPer];
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
        xv[j] = xs[t * kTileP + pr * kRowsPer + j];
        const float xdt = xv[j] * dtv;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          st[j][i] = fmaf(xdt, bv[i], st[j][i] * al);
          acc = fmaf(st[j][i], cv[i], acc);
        }
        yv[j] = acc;
      }
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
#pragma unroll
        for (int o = 1; o < kGroups; o <<= 1)
          yv[j] += __shfl_xor_sync(0xffffffffu, yv[j], o);
      }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < kRowsPer; ++j) {
          const int p = p0 + pr * kRowsPer + j;
          if (p < p_dim)
            store(yb + static_cast<int64_t>(t0 + t) * p_dim + p,
                  yv[j] + xv[j] * dsk);
        }
      }
    }
    __syncthreads();               // every thread is done with this stage
    if (more) put();
    __syncthreads();
  }
}

template <typename T, int N>
int launch(const void* x, const float* dt, const float* a_log, const void* B,
           const void* C, const float* d_skip, void* y, int bt, int h,
           int seq, int p_dim, cudaStream_t stream) {
  const dim3 grid((p_dim + kTileP - 1) / kTileP, h, bt);
  ssd_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(B),
      static_cast<const T*>(C), d_skip, static_cast<T*>(y), h, seq, p_dim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* a_log,
             const void* B, const void* C, const float* d_skip, void* y,
             int bt, int h, int seq, int p_dim, int n,
             cudaStream_t stream) {
#define REPRO_SSD(NN)                                                        \
  case NN:                                                                   \
    return launch<T, NN>(x, dt, a_log, B, C, d_skip, y, bt, h, seq, p_dim,   \
                         stream)
  switch (n) {
    REPRO_SSD(8);
    REPRO_SSD(16);
    REPRO_SSD(32);
    REPRO_SSD(64);
    REPRO_SSD(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SSD
}

}  // namespace

// x and y (bt, h, seq, p), B and C (bt, seq, n), one dtype (1 = bf16, 0 =
// f32); dt (bt, h, seq), A_log and D (h,) f32.  n in {8, 16, 32, 64, 128}.
// Returns cudaGetLastError().
extern "C" int repro_mamba_ssd_scan(const void* x, const float* dt,
                                    const float* a_log, const void* B,
                                    const void* C, const float* d_skip,
                                    void* y, int bt, int h, int seq, int p,
                                    int n, int bf16, void* stream) {
  if (bt < 1 || bt > 65535 || h < 1 || h > 65535 || seq < 1 || p < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, dt, a_log, B, C, d_skip, y, bt, h,
                                        seq, p, n, s)
              : dispatch<float>(x, dt, a_log, B, C, d_skip, y, bt, h, seq, p,
                                n, s);
}
