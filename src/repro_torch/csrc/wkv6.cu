// The RWKV-6 WKV recurrence from a zero state, hand-written for Hopper
// (sm_90a), in two forms chosen by dtype and key width.
//
// Replaces the Pallas TPU kernel wkv6_chunked of
// src/repro/kernels/wkv6.py (B8, :46; _kernel :18).  Per (b, h), with the
// (K, V) state S starting at zero, for t = 0 .. seq − 1:
//     y_t[v] = Σ_k r_t[k] · (S[k][v] + u[k] · k_t[k] · v_t[v])
//     S[k][v] = S[k][v] · w_t[k] + k_t[k] · v_t[v]
// r, k (B, H, S, K) and v (B, H, S, V) in one dtype (bf16 or f32), w
// (B, H, S, K) f32, u (H, K) f32; math in f32, y (B, H, S, V) f32 or bf16.
// Every tensor is read and written through the element strides it comes
// with (its last dimension contiguous), so the RWKV-6 block hands over the
// (B, H, S, ·) views of its (B, S, H, ·) projections and its f32 decay,
// and takes y back in (B, S, H, V) memory: no copy either way.
//
// bf16 r, k, v with K <= 64 — the full-width path — run a chunked form on
// the tensor cores (wkv_wgmma_kernel<V>).  Over chunks of 64 steps cut into
// four sub-chunks of 16, with every decay factor a product of w (no log,
// no exp: a product of numbers in (0, 1] neither overflows nor cancels,
// however strong the decay):
//     fp_t = Π w_q over the sub-chunk's steps before t, fq_s = Π w_q over
//     its steps after s, T_I the sub-chunk's whole product;
//     y_inter = (r ⊙ fp ⊙ Π_{m<I} T_m) · S
//     A[t][s] (sub-chunk J < I) = (r_t ⊙ fp_t ⊙ Π_{J<m<I} T_m) · (k_s ⊙ fq_s)
//     A[t][s] (same sub-chunk, s < t) = Σ_k r_t k_s Π_{s<q<t} w_q,
//         the running product down each column on the CUDA cores, in f32
//     A[t][t] = Σ_k r_t u k_t
//     y = y_inter + A · v
//     S' = (Π_m T_m) ⊙ S + (k ⊙ fq ⊙ Π_{m>J} T_m)ᵀ · v
// The factorised form (r ⊙ e^c)·(k ⊙ e^−c)ᵀ over a whole chunk would
// overflow e^−c once decays are strong (w ~ 1e-20); here each factor is a
// product of decays, at most 1.  r, k and v are exact bf16 operands; each
// f32 operand (the decayed r and k, the state, A) is split into three bf16
// parts, hi = bf16(x), mid = bf16(x − hi), lo = bf16(x − hi − mid), and a
// product of two f32 operands keeps the cross terms of part orders i + j
// <= 2 (six products; with one exact side three).  Two parts lie up to 1.4x
// outside the f32 limit the checks hold (an emulation of this arithmetic
// against the Pallas kernel, tests/test_torch_attn_scan_kernels.py), three
// within 0.074 of it.
//
// What bounds it: at rwkv6-7b's prefill (2 × 64 heads, K = V = 64, 2048
// steps) the inputs and output are r, k, v bf16 100.7 MB, w f32 67.1 MB and
// y f32 67.1 MB: 0.070 ms at 3.35 TB/s; the products, splits included,
// 35.4 GFLOP (0.036 ms at 989 TFLOP/s).  The chunks of one (b, h) form a
// chain through S, so the design is one block per (head, batch row) — 128
// blocks at rwkv6-7b, one wave — that loops over the chunks with S in
// registers.  The block is two warpgroups; each owns V/2 columns of y and
// of S, and the CUDA-core passes are shared out over all 256 threads:
//   * thread 0 loads each chunk's r, k, v (boxes of 16 columns, 32-byte
//     swizzle) and w (two boxes of 32 f32 columns, 128-byte swizzle) by TMA
//     into a two-stage ring, two chunks ahead (4-D tensor maps on the
//     caller's strides; rows past S and columns past K read as zeros, so
//     K = 32 runs padded);
//   * all threads: the decay products fp, fq, T and the products of T per
//     channel; k ⊙ fq (⊙ Π T) as three bf16 parts (KJ, the B operand of
//     the blocks below the diagonal; W, the A operand of the state update);
//   * A (64 x 64, f32) is put together in shared memory by both groups at
//     once: group 0 runs y_inter (rs: r ⊙ fp ⊙ Π T as register operands
//     against S's parts) and A's blocks below the diagonal (rs, m64n16),
//     group 1 the diagonal blocks on the CUDA cores (the running product
//     of w down each column, one loop of 16 rows for every lane so the
//     warp does not diverge) and then its y_inter;
//   * A's three bf16 parts (K-major) replace KJ and fp in shared memory;
//     y += A·v and S += Wᵀ·v run as one batch of ss wgmmas (v MN-major);
//   * y rounded once and stored from the accumulator, rows < S.
// Each batch of register-operand wgmmas makes all its operands before the
// first of them: an operand made between two wgmmas of a batch makes the
// compiler fence, and wait, there.  What holds it now (PERF.md §6): the
// chain of passes inside a chunk, each waiting on the one before it.
//
// f32 r, k, v — phase 16's reduced parity — and bf16 with K = 128 keep the
// step recurrence on the CUDA cores (wkv6_kernel<T, K>): one block of 4·V
// threads per (b, h), each thread owning K/4 rows of one state column in
// registers; 16 steps of r, k, w and v are staged in shared memory while
// the next 16 are fetched.  Each step uses fused multiply-adds where the
// reference rounds twice; the tolerance of the tests says so.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// element strides of the five strided tensors, as the wrapper passes them
struct Strides {
  int64_t rb, rh, rs;   // r (B, H, S, K), K contiguous
  int64_t kb, kh, ks;   // k
  int64_t vb, vh, vs;   // v (B, H, S, V)
  int64_t wb, wh, ws;   // w (B, H, S, K) f32
  int64_t yb, yh, ys;   // y (B, H, S, V)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---- the step recurrence on the CUDA cores -----------------------------------
constexpr int kSplit = 4;      // threads sharing one state column
constexpr int kSteps = 16;     // steps staged in shared memory at a time
constexpr int kMinV = 32, kMaxV = 64;   // 256 threads at most: 255 registers

template <typename T, typename YT, int K>
__global__ void __launch_bounds__(kSplit * kMaxV)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, YT* __restrict__ y, Strides st,
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
  const T* rb = r + b * st.rb + h * st.rh;
  const T* kb = k + b * st.kb + h * st.kh;
  const float* wb = w + b * st.wb + h * st.wh;
  const T* vb = v + b * st.vb + h * st.vh;
  YT* yb = y + b * st.yb + h * st.yh;

  float stv[kRows], uu[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    stv[i] = 0.f;
    uu[i] = u[static_cast<int64_t>(h) * K + i * kSplit + part];
  }

  // the next stage, fetched into registers: staged element e is step
  // t0 + e / K (e / vd for v), channel e % K
  float pr[kPer], pk[kPer], pw[kPer], pv[kPerV];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * n_threads;
      const int t = t0 + e / K, c = e % K;
      const bool ok = e < kSteps * K && t < seq;
      pr[j] = ok ? to_f32(rb[t * st.rs + c]) : 0.f;
      pk[j] = ok ? to_f32(kb[t * st.ks + c]) : 0.f;
      pw[j] = ok ? wb[t * st.ws + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPerV; ++j) {
      const int e = tid + j * n_threads;
      const int t = t0 + e / vd;
      pv[j] = t < seq ? to_f32(vb[t * st.vs + e % vd]) : 0.f;
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
        y0 = fmaf(a.x, fmaf(uu[i], kv0, stv[i]), y0);
        stv[i] = fmaf(stv[i], a.z, kv0);
        const float4 c = row[(i + 1) * kSplit];
        const float kv1 = c.y * vv;
        y1 = fmaf(c.x, fmaf(uu[i + 1], kv1, stv[i + 1]), y1);
        stv[i + 1] = fmaf(stv[i + 1], c.z, kv1);
      }
      float yv = y0 + y1;
      yv += __shfl_xor_sync(0xffffffffu, yv, 1);
      yv += __shfl_xor_sync(0xffffffffu, yv, 2);
      if (part == 0) store(yb + static_cast<int64_t>(t0 + t) * st.ys + col, yv);
    }
    __syncthreads();               // every thread is done with this stage
    if (more) put();
    __syncthreads();
  }
}

template <typename T, typename YT, int K>
int launch_step(const void* r, const void* k, const void* v, const float* w,
                const float* u, void* y, const Strides& st, int b, int h,
                int seq, int vd, cudaStream_t stream) {
  const dim3 grid(h, b);
  const int threads = kSplit * vd;
  const size_t smem = kSteps * K * sizeof(float4) + kSteps * vd * sizeof(float);
  wkv6_kernel<T, YT, K><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, static_cast<YT*>(y), st, seq, vd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename YT>
int dispatch_step(const void* r, const void* k, const void* v, const float* w,
                  const float* u, void* y, const Strides& st, int b, int h,
                  int seq, int kd, int vd, cudaStream_t stream) {
  switch (kd) {
    case 32: return launch_step<T, YT, 32>(r, k, v, w, u, y, st, b, h, seq, vd, stream);
    case 64: return launch_step<T, YT, 64>(r, k, v, w, u, y, st, b, h, seq, vd, stream);
    case 128: return launch_step<T, YT, 128>(r, k, v, w, u, y, st, b, h, seq, vd, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bf16: the chunked form on the tensor cores ------------------------------
namespace tc {

constexpr int kQ = 64;           // steps of a chunk: wgmma's M
constexpr int kSub = 16;         // steps of a sub-chunk
constexpr int kNSub = kQ / kSub;
constexpr int kKP = 64;          // key channels, K padded to 64
constexpr int kGroups = 2;       // warpgroups: each owns V/2 columns
constexpr int kThreads = 128 * kGroups;
constexpr int kParts = 3;        // bf16 parts of an f32 operand

// Shared memory, every tile a multiple of 1 KB from a 1 KB-aligned base:
// two stages of (r, k, v, w), the state's parts, the parts of k ⊙ fq ⊙ Π T
// (W, the state update's A operand), of k ⊙ fq for the three off-diagonal
// block columns (KJ), then fp and fq (f32, [t][channel]), the sub-chunks'
// products T and the products built from them (Pre, Post, G), u and the
// stages' mbarriers.  Once KJ and fp are read, A's three parts (K-major,
// rows t) take their place; once fq is read, A in f32 ([t][s]) takes its.
template <int V>
struct Layout {
  static constexpr uint32_t kR = kQ * kKP * 2;          // r or k: 4 chunks of 16
  static constexpr uint32_t kV = kQ * V * 2;            // v: V/16 chunks
  static constexpr uint32_t kW = kQ * kKP * 4;          // w: two boxes of 32 f32
  static constexpr uint32_t kStage = 2 * kR + kV + kW;
  static constexpr uint32_t kSPart = kKP * V * 2;       // one part of S
  static constexpr uint32_t kWPart = kQ * kKP * 2;      // one part of W
  static constexpr uint32_t kKJPart = kSub * kKP * 2;   // one part of one KJ
  static constexpr uint32_t kS = 2 * kStage;
  static constexpr uint32_t kWp = kS + kParts * kSPart;
  static constexpr uint32_t kKJ = kWp + kParts * kWPart;
  static constexpr uint32_t kFp = kKJ + (kNSub - 1) * kParts * kKJPart;
  static constexpr uint32_t kFq = kFp + kQ * kKP * 4;
  static constexpr uint32_t kT = kFq + kQ * kKP * 4;     // T [I][ch]
  static constexpr uint32_t kPre = kT + kNSub * kKP * 4; // Π_{m<I} T, I ≤ 4
  static constexpr uint32_t kPost = kPre + (kNSub + 1) * kKP * 4;  // Π_{m>J}
  static constexpr uint32_t kG = kPost + kNSub * kKP * 4;  // Π_{J<m<I} [J][I]
  static constexpr uint32_t kU = kG + kNSub * kNSub * kKP * 4;
  static constexpr uint32_t kAPart = kQ * kQ * 2;       // one part of A
  static constexpr uint32_t kA = kKJ;                   // A's parts over KJ, fp
  static constexpr uint32_t kA32 = kFq;                 // A in f32 over fq
  static_assert(kParts * kAPart <= kFq - kKJ && kQ * kQ * 4 <= kT - kFq,
                "A's buffers fit where KJ, fp and fq were");
  static constexpr uint32_t kBar = kU + kKP * 4;
  static constexpr size_t kBytes = 1024 + kBar + 2 * 8;
};

__device__ __forceinline__ uint32_t bits(const __nv_bfloat162& v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// three bf16 parts of two f32 values, as bf16x2 registers:
// hi = bf16(v), mid = bf16(v − hi), lo = bf16(v − hi − mid)
__device__ __forceinline__ void split3(float a, float b, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    p[i] = bits(h);
    a -= hf.x;
    b -= hf.y;
  }
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
wkv_wgmma_kernel(const __grid_constant__ CUtensorMap tr,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tw,
                 const float* __restrict__ u, void* __restrict__ y,
                 int y_bf16, Strides st, int seq, int kd) {
  using hopper::desc_sw32;
  using L = Layout<V>;
  constexpr int VH = V / kGroups;            // columns a warpgroup owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_u32 = hopper::smem_u32(smem_raw);
  const uint32_t s_base = (raw_u32 + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (s_base - raw_u32);
  auto f32_at = [&](uint32_t off) {
    return reinterpret_cast<float*>(base_ptr + off);
  };
  float* fp_s = f32_at(L::kFp);
  float* fq_s = f32_at(L::kFq);
  float* T_s = f32_at(L::kT);
  float* pre_s = f32_at(L::kPre);
  float* post_s = f32_at(L::kPost);
  float* g_s = f32_at(L::kG);
  float* a_s = f32_at(L::kA32);                // A [t][s], f32
  float* u_s = f32_at(L::kU);
  const uint32_t s_bar = s_base + L::kBar;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wq = warp % 4;    // warpgroup, warp inside it
  const int v0 = wg * VH;                    // the warpgroup's first column
  const int row0 = 16 * wq + lane / 4, col0 = 2 * (lane % 4);
  const int n_chunks = (seq + kQ - 1) / kQ;

  auto stage_r = [&](int stage) { return s_base + stage * L::kStage; };
  auto issue = [&](int c, int stage) {
    const uint32_t sr = stage_r(stage), sk = sr + L::kR, sv = sk + L::kR;
    const uint32_t sw = sv + L::kV;
    const uint32_t bar = s_bar + 8 * stage;
    hopper::mbar_expect_tx(bar, L::kStage);
#pragma unroll
    for (int q = 0; q < kKP / 16; ++q) {
      hopper::tma_load_4d(sr + q * kQ * 32, &tr, bar, 16 * q, c * kQ, h, b);
      hopper::tma_load_4d(sk + q * kQ * 32, &tk, bar, 16 * q, c * kQ, h, b);
    }
#pragma unroll
    for (int q = 0; q < V / 16; ++q)
      hopper::tma_load_4d(sv + q * kQ * 32, &tv, bar, 16 * q, c * kQ, h, b);
#pragma unroll
    for (int q = 0; q < kKP / 32; ++q)
      hopper::tma_load_4d(sw + q * kQ * 32 * 4, &tw, bar, 32 * q, c * kQ, h, b);
  };

  if (tid == 0) {
    hopper::mbar_init(s_bar, 1);
    hopper::mbar_init(s_bar + 8, 1);
    hopper::mbar_fence_init();
  }
  if (tid < kKP) u_s[tid] = tid < kd ? u[static_cast<int64_t>(h) * kd + tid] : 0.f;
  __syncthreads();
  if (tid == 0) {
    issue(0, 0);
    if (n_chunks > 1) issue(1, 1);
  }

  float S[VH / 2];               // the state: rows k (64), this group's columns
#pragma unroll
  for (int i = 0; i < VH / 2; ++i) S[i] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    const uint32_t parity = (c >> 1) & 1;
    const uint32_t sr = stage_r(stage), sk = sr + L::kR, sv = sk + L::kR;
    const float* w_s = reinterpret_cast<const float*>(
        base_ptr + (sv + L::kV - s_base));
    // w element (t, ch): two boxes of (64 rows x 32 channels), swizzled
    auto w_at = [&](int t, int ch) {
      return w_s[(ch >> 5) * (kQ * 32) + hopper::f32_sw128_offset(t, ch & 31)];
    };
    hopper::mbar_wait(s_bar + 8 * stage, parity);

    // fp, fq and T: thread (channel, sub-chunk I)
    {
      const int ch = tid % kKP, I = tid / kKP;
      float wv[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) wv[t] = w_at(I * kSub + t, ch);
      float run = 1.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        fp_s[(I * kSub + t) * kKP + ch] = run;
        run *= wv[t];
      }
      T_s[I * kKP + ch] = run;
      run = 1.f;
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t) {
        fq_s[(I * kSub + t) * kKP + ch] = run;
        run *= wv[t];
      }
    }
    __syncthreads();
    // per channel, the products of T: Pre[I] = Π_{m<I} (Pre[4] the whole
    // chunk's), Post[J] = Π_{m>J}, G[J][I] = Π_{J<m<I} for J < I
    if (tid < kKP) {
      const int ch = tid;
      float t[kNSub];
#pragma unroll
      for (int m = 0; m < kNSub; ++m) t[m] = T_s[m * kKP + ch];
      float run = 1.f;
#pragma unroll
      for (int I = 0; I <= kNSub; ++I) {
        pre_s[I * kKP + ch] = run;
        if (I < kNSub) run *= t[I];
      }
      run = 1.f;
#pragma unroll
      for (int J = kNSub - 1; J >= 0; --J) {
        post_s[J * kKP + ch] = run;
        run *= t[J];
      }
#pragma unroll
      for (int J = 0; J < kNSub; ++J) {
        float g = 1.f;
#pragma unroll
        for (int I = J + 1; I < kNSub; ++I) {
          g_s[(J * kNSub + I) * kKP + ch] = g;
          g *= t[I];
        }
      }
    }
    __syncthreads();

    // W = k ⊙ fq ⊙ Post[J] (all 64 rows) and KJ = k ⊙ fq (rows of
    // sub-chunks 0-2), three bf16 parts each, in k's swizzled layout.  A
    // warp writes 4 rows of one 16-channel chunk at a time: 32 banks.
    {
      const uint32_t s_w = s_base + L::kWp, s_kj = s_base + L::kKJ;
      const int pr = lane % 8, rr = lane / 8;
#pragma unroll 2
      for (int it = warp; it < (kKP / 16) * (kQ / 4); it += kThreads / 32) {
        const int chunk = it / (kQ / 4), s = 4 * (it % (kQ / 4)) + rr;
        const int ch = 16 * chunk + 2 * pr, J = s / kSub;
        const float2 kv = bf2_to_f2(ld_shared_u32(sk + hopper::sw32_offset(kQ, s, ch)));
        const float2 fq = *reinterpret_cast<const float2*>(&fq_s[s * kKP + ch]);
        float a = kv.x * fq.x, bb = kv.y * fq.y;
        uint32_t p[kParts];
        if (J < kNSub - 1) {
          split3(a, bb, p);
          const uint32_t off = hopper::sw32_offset(kSub, s - J * kSub, ch);
#pragma unroll
          for (int q = 0; q < kParts; ++q)
            st_shared_u32(s_kj + (J * kParts + q) * L::kKJPart + off, p[q]);
        }
        const float2 po = *reinterpret_cast<const float2*>(&post_s[J * kKP + ch]);
        split3(a * po.x, bb * po.y, p);
        const uint32_t off = hopper::sw32_offset(kQ, s, ch);
#pragma unroll
        for (int q = 0; q < kParts; ++q) st_shared_u32(s_w + q * L::kWPart + off, p[q]);
      }
    }

    hopper::fence_proxy_async();
    __syncthreads();             // W and KJ are in shared memory

    // register-A slice kk of (r ⊙ fp ⊙ f) in three parts: register tt
    // holds row row0 + 8(tt % 2), channels 16kk + 8(tt / 2) + col0 + e;
    // f is a row of per-channel factors in shared memory (zeros if null)
    auto a_parts = [&](int kk, const float* fac, uint32_t (&a)[kParts][4]) {
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int row = row0 + 8 * (tt % 2);
        const int ch = 16 * kk + 8 * (tt / 2) + col0;
        const float2 rv = bf2_to_f2(ld_shared_u32(sr + hopper::sw32_offset(kQ, row, ch)));
        const float2 fpv = *reinterpret_cast<const float2*>(&fp_s[row * kKP + ch]);
        float x0 = 0.f, x1 = 0.f;
        if (fac != nullptr) {
          const float2 fv = *reinterpret_cast<const float2*>(&fac[ch]);
          x0 = rv.x * fpv.x * fv.x;
          x1 = rv.y * fpv.y * fv.y;
        }
        uint32_t p[kParts];
        split3(x0, x1, p);
#pragma unroll
        for (int q = 0; q < kParts; ++q) a[q][tt] = p[q];
      }
    };

    // y_inter = (r ⊙ fp ⊙ Pre[I]) · S, this group's columns (S's parts
    // MN-major, rows k): one batch that makes all its register operands
    // first, then issues its wgmmas behind one fence (an operand made
    // between two wgmmas makes the compiler fence and wait there)
    float yv[VH / 2];            // y: rows t, this group's columns
#pragma unroll
    for (int i = 0; i < VH / 2; ++i) yv[i] = 0.f;
    uint32_t a[kKP / 16][kParts][4];
    auto y_inter = [&]() {
      if (c == 0) return;
      const uint32_t s_s = s_base + L::kS + (v0 / 16) * (kKP * 32);
#pragma unroll
      for (int kk = 0; kk < kKP / 16; ++kk) a_parts(kk, pre_s + wq * kKP, a[kk]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKP / 16; ++kk)
#pragma unroll
        for (int qa = 0; qa < kParts; ++qa)
#pragma unroll
          for (int qb = 0; qa + qb < kParts; ++qb)
            hopper::Wgmma<VH>::rs(
                yv, a[kk][qa],
                desc_sw32(s_s + qb * L::kSPart + kk * 16 * 32, kKP * 32, 256),
                1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(yv);
    };

    // A (64 x 64, f32, [t][s]) in shared memory, the two warpgroups at
    // once: group 0 its blocks below the diagonal on the tensor cores,
    // group 1 the diagonal blocks on the CUDA cores
    if (wg == 0) {
      y_inter();
      // block column J < 3, rows of sub-chunk I = wq > J:
      // (r ⊙ fp ⊙ G[J][I]) · KJᵀ (KJ K-major: rows s); the blocks above the
      // diagonal (J > wq) are zeros
#pragma unroll
      for (int J = 0; J < kNSub; ++J) {
        float dj[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) dj[i] = 0.f;
        if (J < kNSub - 1) {
          const uint32_t s_kj = s_base + L::kKJ + J * kParts * L::kKJPart;
          const float* fac = wq > J ? g_s + (J * kNSub + wq) * kKP : nullptr;
#pragma unroll
          for (int kk = 0; kk < kKP / 16; ++kk) a_parts(kk, fac, a[kk]);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKP / 16; ++kk)
#pragma unroll
            for (int qa = 0; qa < kParts; ++qa)
#pragma unroll
              for (int qb = 0; qa + qb < kParts; ++qb)
                hopper::Wgmma<16>::rs_kmajor(
                    dj, a[kk][qa],
                    desc_sw32(s_kj + qb * L::kKJPart + kk * kSub * 32, 16, 256),
                    1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_operand(dj);
        }
        if (J != wq) {           // the diagonal block is group 1's
#pragma unroll
          for (int t2 = 0; t2 < 4; ++t2) {
            const int row = row0 + 8 * (t2 % 2);
            const int col = kSub * J + 8 * (t2 / 2) + col0;
            *reinterpret_cast<float2*>(&a_s[row * kQ + col]) =
                make_float2(dj[2 * t2], dj[2 * t2 + 1]);
          }
        }
      }
    } else {
      // warp wq: the diagonal block of sub-chunk I = wq.  Lanes 4g .. 4g + 3
      // hold 16 channels each and walk column g (rows g + 1 .. 15), then
      // column 14 − g (rows 15 − g .. 15): 16 rows for every group, so the
      // warp runs one loop without divergence (group 7's column 7 has 8).
      // Down a column they keep k_s ⊙ Π w (the running product of the
      // decays since s), the next row's r loaded while this one is summed;
      // the 4 lanes' sums are added with shuffles.  Then the zeros above
      // the diagonal and A[t][t] = Σ r_t u k_t.
      const int I = wq, g = lane / 4, qk = lane % 4;
      float* ab = a_s + (kSub * I) * kQ + kSub * I;     // the block's (0, 0)
      auto row16 = [&](uint32_t tile, int row, float (&x)[16]) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint4 raw;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
                       : "r"(tile + hopper::sw32_offset(kQ, row, 16 * qk + 8 * half)));
          const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = bf2_to_f2(wd[i]);
            x[8 * half + 2 * i] = f.x;
            x[8 * half + 2 * i + 1] = f.y;
          }
        }
      };
      const float* wbox = w_s + (qk >> 1) * (kQ * 32);
      const int c0 = (qk & 1) * 4;                // first 4-channel chunk
      const int turn = kSub - 1 - g;              // rows of column g
      // row t of step i: column g's rows first, then column 14 − g's (t = i)
      auto row_of = [&](int i) { return i < turn ? g + 1 + i : i; };
      float ke[16], rv[16];
      row16(sk, I * kSub + g, ke);
      row16(sr, I * kSub + row_of(0), rv);
#pragma unroll 8
      for (int i = 0; i < kSub; ++i) {
        const int t = row_of(i), s_loc = i < turn ? g : kSub - 2 - g;
        const bool live = i < turn || g < 7;
        if (i == turn) row16(sk, I * kSub + s_loc, ke);  // column 14 − g
        const int row = I * kSub + t;
        float4 w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w4[j] = *reinterpret_cast<const float4*>(
              wbox + row * 32 + (((c0 + j) ^ (row & 7)) << 2));
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j % 4] = fmaf(rv[j], ke[j], acc[j % 4]);
        if (i + 1 < kSub) row16(sr, I * kSub + row_of(i + 1), rv);
        float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (qk == 0 && live) ab[t * kQ + s_loc] = sum;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ke[4 * j] *= w4[j].x;
          ke[4 * j + 1] *= w4[j].y;
          ke[4 * j + 2] *= w4[j].z;
          ke[4 * j + 3] *= w4[j].w;
        }
      }
      for (int e = lane; e < kSub * kSub; e += 32) {
        const int t = e / kSub, sl = e % kSub;
        if (sl > t) ab[t * kQ + sl] = 0.f;
      }
      {
        const int t = lane / 2, hc = lane % 2, row = I * kSub + t;
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < kKP / 2; i += 2) {
          const int ch = hc * (kKP / 2) + i;
          const float2 rv2 = bf2_to_f2(ld_shared_u32(sr + hopper::sw32_offset(kQ, row, ch)));
          const float2 kv2 = bf2_to_f2(ld_shared_u32(sk + hopper::sw32_offset(kQ, row, ch)));
          acc = fmaf(rv2.x * u_s[ch], kv2.x, acc);
          acc = fmaf(rv2.y * u_s[ch + 1], kv2.y, acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (hc == 0) ab[t * kQ + t] = acc;
      }
      y_inter();
    }
    __syncthreads();             // A is in shared memory; KJ and fp are free

    // A's three bf16 parts (K-major: rows t, 16 columns s a chunk), in
    // place of KJ and fp; a warp writes 4 rows of one chunk at a time
    {
      const uint32_t s_a = s_base + L::kA;
      const int pr = lane % 8, rr = lane / 8;
#pragma unroll 2
      for (int it = warp; it < (kQ / 16) * (kQ / 4); it += kThreads / 32) {
        const int chunk = it / (kQ / 4), t = 4 * (it % (kQ / 4)) + rr;
        const int sc = 16 * chunk + 2 * pr;
        const float2 av = *reinterpret_cast<const float2*>(&a_s[t * kQ + sc]);
        uint32_t p[kParts];
        split3(av.x, av.y, p);
        const uint32_t off = hopper::sw32_offset(kQ, t, sc);
#pragma unroll
        for (int q = 0; q < kParts; ++q) st_shared_u32(s_a + q * L::kAPart + off, p[q]);
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();             // A's parts are in shared memory

    // y += A · v (A K-major, v MN-major) and, after S = Pre[4] ⊙ S (rows k
    // of the accumulator), S += Wᵀ · v (W and v both MN-major): one batch
    {
      const float tot0 = pre_s[kNSub * kKP + row0];
      const float tot1 = pre_s[kNSub * kKP + row0 + 8];
#pragma unroll
      for (int i = 0; i < VH / 2; ++i) S[i] *= (i % 4) < 2 ? tot0 : tot1;
    }
    hopper::wgmma_fence();
    {
      const uint32_t s_vh = sv + (v0 / 16) * (kQ * 32);
      const uint32_t s_a = s_base + L::kA, s_w = s_base + L::kWp;
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        const uint64_t dv = desc_sw32(s_vh + kk * 16 * 32, kQ * 32, 256);
#pragma unroll
        for (int q = 0; q < kParts; ++q)
          hopper::Wgmma<VH>::template ss<0, 1>(
              yv, desc_sw32(s_a + q * L::kAPart + kk * kQ * 32, 16, 256), dv,
              1);
#pragma unroll
        for (int q = 0; q < kParts; ++q)
          hopper::Wgmma<VH>::template ss<1, 1>(
              S, desc_sw32(s_w + q * L::kWPart + kk * 16 * 32, kQ * 32, 256),
              dv, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(yv);
    hopper::fence_operand(S);

    // y, rows < S, this group's columns, rounded once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = c * kQ + row0 + 8 * r;
      if (t < seq) {
        const int64_t off = b * st.yb + h * st.yh + t * st.ys + v0;
#pragma unroll
        for (int j = 0; j < VH / 8; ++j) {
          const int vcol = 8 * j + col0;
          const float y0 = yv[4 * j + 2 * r], y1 = yv[4 * j + 2 * r + 1];
          if (y_bf16)
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(y) + off + vcol) =
                __floats2bfloat162_rn(y0, y1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(y) + off + vcol) =
                make_float2(y0, y1);
        }
      }
    }

    // S's three parts for the next chunk's y_inter (MN-major B: rows k)
    if (c + 1 < n_chunks) {
      const uint32_t s_s = s_base + L::kS;
#pragma unroll
      for (int j = 0; j < VH / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off =
              hopper::sw32_offset(kKP, row0 + 8 * r, v0 + 8 * j + col0);
          uint32_t p[kParts];
          split3(S[4 * j + 2 * r], S[4 * j + 2 * r + 1], p);
#pragma unroll
          for (int q = 0; q < kParts; ++q)
            st_shared_u32(s_s + q * L::kSPart + off, p[q]);
        }
      }
      hopper::fence_proxy_async();
    }
    __syncthreads();             // the stage and every part read by all warps
    if (tid == 0 && c + 2 < n_chunks) issue(c + 2, stage);
  }
}

}  // namespace tc

template <int V>
int launch_tc(const void* r, const void* k, const void* v, const float* w,
              const float* u, void* y, int y_bf16, const Strides& st, int b,
              int h, int seq, int kd, cudaStream_t stream) {
  using L = tc::Layout<V>;
  // each of r, k, v, w as (C, S, H, B) on its own strides
  const uint64_t u_s = static_cast<uint64_t>(seq), u_h = h, u_b = b;
  const uint64_t rdims[4] = {static_cast<uint64_t>(kd), u_s, u_h, u_b};
  const uint64_t vdims[4] = {static_cast<uint64_t>(V), u_s, u_h, u_b};
  auto bytes = [](int64_t a, int64_t bb, int64_t c, int esz, uint64_t (&o)[3]) {
    o[0] = static_cast<uint64_t>(a) * esz;
    o[1] = static_cast<uint64_t>(bb) * esz;
    o[2] = static_cast<uint64_t>(c) * esz;
  };
  uint64_t rst[3], kst[3], vst[3], wst[3];
  bytes(st.rs, st.rh, st.rb, 2, rst);
  bytes(st.ks, st.kh, st.kb, 2, kst);
  bytes(st.vs, st.vh, st.vb, 2, vst);
  bytes(st.ws, st.wh, st.wb, 4, wst);
  const uint32_t q = tc::kQ;
  const uint32_t box16[4] = {16, q, 1, 1};
  const uint32_t box32[4] = {32, q, 1, 1};
  CUtensorMap tr, tk, tv, tw;
  if (!hopper_host::bf16_map_sw32_strided(&tr, r, 4, rdims, rst, box16) ||
      !hopper_host::bf16_map_sw32_strided(&tk, k, 4, rdims, kst, box16) ||
      !hopper_host::bf16_map_sw32_strided(&tv, v, 4, vdims, vst, box16) ||
      !hopper_host::f32_map_sw128_strided(&tw, w, 4, rdims, wst, box32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      tc::wkv_wgmma_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::wkv_wgmma_kernel<V><<<dim3(h, b), tc::kThreads, L::kBytes, stream>>>(
      tr, tk, tv, tw, u, y, y_bf16, st, seq, kd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k (b, h, seq, kd) and v (b, h, seq, vd) in one dtype (in_bf16: 1 =
// bf16, 0 = f32), w (b, h, seq, kd) f32, u (h, kd) f32, y (b, h, seq, vd)
// f32 or bf16 (y_bf16); each with its last dimension contiguous and
// `strides` holding 15 element strides: r, k, v, w, y each (b, h, seq).
// bf16 with kd in {32, 64} and vd in {32, 64} runs the chunked form on the
// tensor cores (r, k, v, w 16-byte aligned, every stride a multiple of 16
// bytes); otherwise the step recurrence, kd in {32, 64, 128}, vd 32 or 64.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const float* w, const float* u, void* y,
                          const int64_t* strides, int b, int h, int seq,
                          int kd, int vd, int in_bf16, int y_bf16,
                          void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || seq < 1 || vd < kMinV ||
      vd > kMaxV || vd % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0],  strides[1],  strides[2],  strides[3],
                   strides[4],  strides[5],  strides[6],  strides[7],
                   strides[8],  strides[9],  strides[10], strides[11],
                   strides[12], strides[13], strides[14]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16 && (kd == 32 || kd == 64)) {
    return vd == 64 ? launch_tc<64>(r, k, v, w, u, y, y_bf16, st, b, h, seq, kd, s)
                    : launch_tc<32>(r, k, v, w, u, y, y_bf16, st, b, h, seq, kd, s);
  }
  if (in_bf16)
    return y_bf16 ? dispatch_step<bf16, bf16>(r, k, v, w, u, y, st, b, h, seq, kd, vd, s)
                  : dispatch_step<bf16, float>(r, k, v, w, u, y, st, b, h, seq, kd, vd, s);
  return y_bf16 ? dispatch_step<float, bf16>(r, k, v, w, u, y, st, b, h, seq, kd, vd, s)
                : dispatch_step<float, float>(r, k, v, w, u, y, st, b, h, seq, kd, vd, s);
}
