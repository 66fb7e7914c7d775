// Fused dual-batch server update over the flat parameter store (paper §3.4),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dbl_merge.py:
//   dbl_apply_flat2d  (B1, :229) — _kernel_apply, _kernel_apply_vel,
//                      _kernel_apply_master, _kernel_apply_master_vel
//       v' = m·v + g;  w' = w − lr·v'            (v ≡ g when m = 0)
//   dbl_merge_flat2d  (B2, :186) — _kernel, _kernel_vel, _kernel_master,
//                      _kernel_master_vel
//       g = (g_L + f·g_S)·inv, inv = 1/(1+f);  then the same apply
//   dbl_apply_worker_flat2d  (B3, :318) — _kernel_apply_worker (:270),
//                      _kernel_apply_worker_master (:287)
//       v'[wid] = m·v[wid] + g;  d = −lr·v'[wid];  w' = w + f·d
//       (one simulated parameter-server event; only worker wid's row block
//       of the stacked (n_workers, rows, 128) velocity is read or written)
// In the master forms the update runs on the f32 master and the same pass
// writes the master and its round-to-nearest-even bf16 shadow; the shadow's
// old value is never read (as at dbl_merge.py:108).  Every output is written
// over its input (the in-place input_output_aliases contract).
//
// What bounds it: nothing but device-memory bytes.  Each element costs 2 to
// 6 flops and 12 to 26 bytes: B1 12 / 20 / 14 / 22 and B2 16 / 24 / 18 / 26
// bytes (plain, vel, master, master+vel); B3 20 (f32: read w, g, v[wid],
// write w, v[wid]) or 22 (master: the bf16 shadow is written, never read).  At the full ResNet-18 store
// (88,064 × 128 elements) that is 135–293 MB a step, a 40–87 µs bound at
// the 3.35 TB/s of an H100 SXM.  The design therefore only has to stream:
// one thread per 4 floats (16-byte float4 loads/stores, 8-byte stores of 4
// bf16), a grid-stride loop over the whole contiguous buffer, and enough
// blocks to keep every SM's load queue full.  The TPU's whole-buffer /
// 1024-row tiling existed for VMEM and is not carried over.
//
// B3 is the same sweep over one worker's row block of the velocity (the
// pointer moves by wid·rows·128; every other worker's rows are never
// touched), so it streams as B1's vel form does.  Its scalars come in by
// value from the host, where the simulator's trace keeps them.
//
// Numbers: the float op order is the reference's exactly — (gl + f·gs)·inv,
// then m·v + g, then w − lr·v (B3: m·v + g, then (−lr)·v, then w + f·d) —
// with every multiply and add rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, and the library is built with
// --fmad=false), so no fused multiply-add changes a bit: the kernel is
// bit-equal to the plain PyTorch version of each variant.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 8 × 256 threads = an SM's 2048 threads

__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}

__device__ __forceinline__ void store4(float* p, int64_t i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}

// four floats -> four bf16 (round to nearest even) in one 8-byte store
__device__ __forceinline__ void store4_bf16(__nv_bfloat16* p, int64_t i,
                                            float4 v) {
  __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v.x),
                                         __float2bfloat16_rn(v.y));
  __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v.z),
                                         __float2bfloat16_rn(v.w));
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[i] = packed;
}

// (gl + f·gs)·inv — the dual-batch merge, reference op order
__device__ __forceinline__ float merge1(float gl, float gs, float f,
                                        float inv) {
  return __fmul_rn(__fadd_rn(gl, __fmul_rn(f, gs)), inv);
}

// m·v + g — the server momentum
__device__ __forceinline__ float vel1(float v, float g, float m) {
  return __fadd_rn(__fmul_rn(m, v), g);
}

// w − lr·g — the apply
__device__ __forceinline__ float apply1(float w, float g, float lr) {
  return __fsub_rn(w, __fmul_rn(lr, g));
}

// w: f32 params (or the f32 master when kMaster); shadow: bf16 store
// written from the updated master (kMaster only); ga: the gradient (g_L when
// kMerge); gb: g_S (kMerge only); v: f32 velocity (kVel only).  n4 counts
// float4 groups.
template <bool kMerge, bool kVel, bool kMaster>
__global__ void __launch_bounds__(kThreads)
dbl_sweep(float* __restrict__ w, __nv_bfloat16* __restrict__ shadow,
          const float* __restrict__ ga, const float* __restrict__ gb,
          float* __restrict__ v, int64_t n4, float lr, float factor,
          float inv, float momentum) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n4; i += stride) {
    float4 g = load4(ga, i);
    if constexpr (kMerge) {
      const float4 s = load4(gb, i);
      g.x = merge1(g.x, s.x, factor, inv);
      g.y = merge1(g.y, s.y, factor, inv);
      g.z = merge1(g.z, s.z, factor, inv);
      g.w = merge1(g.w, s.w, factor, inv);
    }
    if constexpr (kVel) {
      float4 vv = load4(v, i);
      vv.x = vel1(vv.x, g.x, momentum);
      vv.y = vel1(vv.y, g.y, momentum);
      vv.z = vel1(vv.z, g.z, momentum);
      vv.w = vel1(vv.w, g.w, momentum);
      store4(v, i, vv);
      g = vv;
    }
    float4 p = load4(w, i);
    p.x = apply1(p.x, g.x, lr);
    p.y = apply1(p.y, g.y, lr);
    p.z = apply1(p.z, g.z, lr);
    p.w = apply1(p.w, g.w, lr);
    store4(w, i, p);
    if constexpr (kMaster) store4_bf16(shadow, i, p);
  }
}

// One simulated-PS event over the flat store (B3).  w: f32 params (or the
// f32 master when kMaster); shadow: bf16 store (kMaster only); g: the
// event's gradient; v: worker wid's row block of the stacked velocity.
template <bool kMaster>
__global__ void __launch_bounds__(kThreads)
dbl_worker_sweep(float* __restrict__ w, __nv_bfloat16* __restrict__ shadow,
                 const float* __restrict__ g, float* __restrict__ v,
                 int64_t n4, float lr, float factor, float momentum) {
  const float neg_lr = -lr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n4; i += stride) {
    const float4 gg = load4(g, i);
    float4 vv = load4(v, i);
    vv.x = vel1(vv.x, gg.x, momentum);
    vv.y = vel1(vv.y, gg.y, momentum);
    vv.z = vel1(vv.z, gg.z, momentum);
    vv.w = vel1(vv.w, gg.w, momentum);
    store4(v, i, vv);
    float4 p = load4(w, i);
    p.x = __fadd_rn(p.x, __fmul_rn(factor, __fmul_rn(neg_lr, vv.x)));
    p.y = __fadd_rn(p.y, __fmul_rn(factor, __fmul_rn(neg_lr, vv.y)));
    p.z = __fadd_rn(p.z, __fmul_rn(factor, __fmul_rn(neg_lr, vv.z)));
    p.w = __fadd_rn(p.w, __fmul_rn(factor, __fmul_rn(neg_lr, vv.w)));
    store4(w, i, p);
    if constexpr (kMaster) store4_bf16(shadow, i, p);
  }
}

int grid_for(int64_t n4) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n4 + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <bool kMerge>
int launch(float* w, __nv_bfloat16* shadow, const float* ga, const float* gb,
           float* v, int64_t n, float lr, float factor, float inv,
           float momentum, cudaStream_t stream) {
  const int64_t n4 = n / 4;
  const dim3 grid(grid_for(n4)), block(kThreads);
  const bool vel = v != nullptr, master = shadow != nullptr;
  if (vel && master)
    dbl_sweep<kMerge, true, true><<<grid, block, 0, stream>>>(
        w, shadow, ga, gb, v, n4, lr, factor, inv, momentum);
  else if (vel)
    dbl_sweep<kMerge, true, false><<<grid, block, 0, stream>>>(
        w, shadow, ga, gb, v, n4, lr, factor, inv, momentum);
  else if (master)
    dbl_sweep<kMerge, false, true><<<grid, block, 0, stream>>>(
        w, shadow, ga, gb, v, n4, lr, factor, inv, momentum);
  else
    dbl_sweep<kMerge, false, false><<<grid, block, 0, stream>>>(
        w, shadow, ga, gb, v, n4, lr, factor, inv, momentum);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  n: elements, a multiple of 4;
// every pointer 16-byte aligned (shadow 8-byte); v / shadow null when the
// variant has no velocity / master.  Returns cudaGetLastError().
extern "C" int repro_dbl_apply_flat2d(float* w, void* shadow, const float* g,
                                      float* v, int64_t n, float lr,
                                      float momentum, void* stream) {
  return launch<false>(w, static_cast<__nv_bfloat16*>(shadow), g, nullptr, v,
                       n, lr, 0.0f, 1.0f, momentum,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int repro_dbl_merge_flat2d(float* w, void* shadow, const float* gl,
                                      const float* gs, float* v, int64_t n,
                                      float lr, float factor, float inv,
                                      float momentum, void* stream) {
  return launch<true>(w, static_cast<__nv_bfloat16*>(shadow), gl, gs, v, n,
                      lr, factor, inv, momentum,
                      static_cast<cudaStream_t>(stream));
}

// B3.  w / shadow / g: (rows, 128) buffers of n = rows·128 elements; vel3:
// the stacked (n_workers, rows, 128) velocity, of which only row block wid
// is used (the caller checks 0 <= wid < n_workers).  shadow null for the
// f32 form.  Same alignment rules and return value as above.
extern "C" int repro_dbl_apply_worker_flat2d(float* w, void* shadow,
                                             const float* g, float* vel3,
                                             int64_t n, int wid, float lr,
                                             float factor, float momentum,
                                             void* stream) {
  const int64_t n4 = n / 4;
  float* v = vel3 + static_cast<int64_t>(wid) * n;
  const dim3 grid(grid_for(n4)), block(kThreads);
  auto* sh = static_cast<__nv_bfloat16*>(shadow);
  auto st = static_cast<cudaStream_t>(stream);
  if (sh != nullptr)
    dbl_worker_sweep<true><<<grid, block, 0, st>>>(w, sh, g, v, n4, lr,
                                                   factor, momentum);
  else
    dbl_worker_sweep<false><<<grid, block, 0, st>>>(w, sh, g, v, n4, lr,
                                                    factor, momentum);
  return static_cast<int>(cudaGetLastError());
}
