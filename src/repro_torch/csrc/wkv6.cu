// The RWKV-6 WKV recurrence from a zero state, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel wkv6_chunked of
// src/repro/kernels/wkv6.py (B8, :46; _kernel :18).  Per (b, h), with the
// (K, V) state S starting at zero, for t = 0 .. seq − 1:
//     y_t[v] = Σ_k r_t[k] · (S[k][v] + u[k] · k_t[k] · v_t[v])
//     S[k][v] = S[k][v] · w_t[k] + k_t[k] · v_t[v]
// r, k, w (B, H, S, K) and v (B, H, S, V) in f32 or bf16 (all four one
// dtype), u (H, K) f32; math in f32, y (B, H, S, V) in the inputs' dtype.
//
// What bounds it: the chain of seq dependent steps, not bytes or flops.
// At rwkv6-7b's prefill (2 × 64 heads, K = V = 64, 2048 steps) the
// inputs and output are about 335 MB of f32 (0.1 ms at 3.35 TB/s) and
// the flops 6.7 G (0.1 ms at 67 TFLOP/s), but every step needs the state
// the step before left.  The TPU kernel's sequential chunk grid with the
// state carried in scratch becomes a loop inside one block per (b, h):
//   * the state lives in registers: 4·V threads, each owning K/4 rows of
//     one column v (rows part, part + 4, ...: neighbouring threads read
//     neighbouring banks); a step is K/4 fused multiply-adds per state
//     element and thread, then two shuffles sum the four partial y[v];
//   * kSteps steps of r, k, w (interleaved as float4, one shared-memory
//     load per row and step) and v are staged in shared memory, and the
//     next kSteps are fetched into registers while the current ones run,
//     so the chain never waits for device memory.
// Per step it uses fused multiply-adds where the reference rounds twice
// (u·kv + S, r·(…) + y, S·w + kv); the tolerance of the tests says so.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 4;      // threads sharing one state column
constexpr int kSteps = 16;     // steps staged in shared memory at a time
constexpr int kMinV = 32, kMaxV = 64;   // 256 threads at most: 255 registers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int K>
__global__ void __launch_bounds__(kSplit * kMaxV)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y, int n_heads,
            int seq, int vd) {
  constexpr int kRows = K / kSplit;                  // state rows a thread owns
  constexpr int kPer = kSteps * K / (kSplit * kMinV);  // staged rkw per thread
  constexpr int kPerV = kSteps / kSplit;               // staged v per thread
  extern __shared__ float4 smem[];
  float4* rkw = smem;                                // [kSteps][K]: r, k, w, 0
  float* vs = reinterpret_cast<float*>(smem + kSteps * K);   // [kSteps][vd]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const int col = tid / kSplit, part = tid % kSplit;
  const int64_t bh = static_cast<int64_t>(b) * n_heads + h;
  const int64_t n_rkw = static_cast<int64_t>(seq) * K;
  const int64_t n_v = static_cast<int64_t>(seq) * vd;
  const T* rb = r + bh * n_rkw;
  const T* kb = k + bh * n_rkw;
  const T* wb = w + bh * n_rkw;
  const T* vb = v + bh * n_v;
  T* yb = y + bh * n_v;

  float st[kRows], uu[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    st[i] = 0.f;
    uu[i] = u[static_cast<int64_t>(h) * K + i * kSplit + part];
  }

  // the next stage, fetched into registers (a stage is contiguous in
  // device memory: steps t0 .. t0 + kSteps − 1 of one (b, h))
  float pr[kPer], pk[kPer], pw[kPer], pv[kPerV];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * n_threads;
      const int64_t i = static_cast<int64_t>(t0) * K + e;
      const bool ok = e < kSteps * K && i < n_rkw;
      pr[j] = ok ? to_f32(rb[i]) : 0.f;
      pk[j] = ok ? to_f32(kb[i]) : 0.f;
      pw[j] = ok ? to_f32(wb[i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPerV; ++j) {
      const int64_t i = static_cast<int64_t>(t0) * vd + tid + j * n_threads;
      pv[j] = i < n_v ? to_f32(vb[i]) : 0.f;
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * n_threads;
      if (e < kSteps * K) rkw[e] = make_float4(pr[j], pk[j], pw[j], 0.f);
    }
#pragma unroll
    for (int j = 0; j < kPerV; ++j) vs[tid + j * n_threads] = pv[j];
  };

  fetch(0);
  put();
  __syncthreads();
  for (int t0 = 0; t0 < seq; t0 += kSteps) {
    const bool more = t0 + kSteps < seq;
    if (more) fetch(t0 + kSteps);
    const int n = min(kSteps, seq - t0);
    for (int t = 0; t < n; ++t) {
      const float vv = vs[t * vd + col];
      const float4* row = rkw + t * K + part;
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; i += 2) {
        const float4 a = row[i * kSplit];
        const float kv0 = a.y * vv;
        y0 = fmaf(a.x, fmaf(uu[i], kv0, st[i]), y0);
        st[i] = fmaf(st[i], a.z, kv0);
        const float4 c = row[(i + 1) * kSplit];
        const float kv1 = c.y * vv;
        y1 = fmaf(c.x, fmaf(uu[i + 1], kv1, st[i + 1]), y1);
        st[i + 1] = fmaf(st[i + 1], c.z, kv1);
      }
      float yv = y0 + y1;
      yv += __shfl_xor_sync(0xffffffffu, yv, 1);
      yv += __shfl_xor_sync(0xffffffffu, yv, 2);
      if (part == 0) store(yb + static_cast<int64_t>(t0 + t) * vd + col, yv);
    }
    __syncthreads();               // every thread is done with this stage
    if (more) put();
    __syncthreads();
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, void* y, int b, int h, int seq, int vd,
           cudaStream_t stream) {
  const dim3 grid(h, b);
  const int threads = kSplit * vd;
  const size_t smem = kSteps * K * sizeof(float4) + kSteps * vd * sizeof(float);
  wkv6_kernel<T, K><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u,
      static_cast<T*>(y), h, seq, vd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const float* u, void* y, int b, int h, int seq, int kd, int vd,
             cudaStream_t stream) {
  switch (kd) {
    case 32: return launch<T, 32>(r, k, v, w, u, y, b, h, seq, vd, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, y, b, h, seq, vd, stream);
    case 128: return launch<T, 128>(r, k, v, w, u, y, b, h, seq, vd, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, w (b, h, seq, kd), v and y (b, h, seq, vd), all one dtype (1 =
// bf16, 0 = f32); u (h, kd) f32.  kd in {32, 64, 128}; vd 32 or 64.
// Returns cudaGetLastError().
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const float* u, void* y, int b,
                          int h, int seq, int kd, int vd, int bf16,
                          void* stream) {
  if (b < 1 || b > 65535 || h < 1 || seq < 1 || vd < kMinV || vd > kMaxV ||
      vd % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, w, u, y, b, h, seq, kd, vd, s)
              : dispatch<float>(r, k, v, w, u, y, b, h, seq, kd, vd, s);
}
