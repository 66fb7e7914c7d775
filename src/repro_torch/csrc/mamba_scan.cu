// The Mamba2 SSD scan from a zero state, hand-written for Hopper (sm_90a),
// in two forms chosen by dtype.
//
// Replaces the Pallas TPU kernel mamba_ssd_scan of
// src/repro/kernels/mamba_scan.py (B7, :63; _kernel :24).  Per (b, h),
// with a = −exp(A_log[h]) and the (P, N) state H starting at zero, for
// t = 0 .. seq − 1:
//     H[p][n] = H[p][n] · exp(dt_t · a) + dt_t · x_t[p] · B_t[n]
//     y_t[p]  = Σ_n H[p][n] · C_t[n] + D[h] · x_t[p]
// x (Bt, H, S, P) and B, C (Bt, S, N) (single group) in f32 or bf16 (one
// dtype), dt (Bt, H, S), A_log and D (H,) f32; math in f32, y (Bt, H, S, P)
// in x's dtype.  Every tensor is read and written through the element
// strides it comes with (its last dimension contiguous), so the Mamba2
// block hands over its (Bt, S, H, P) heads, its f32 dt and the B / C
// columns of its conv output as views, and takes y back in (Bt, S, H, P)
// memory order: no copy either way.
//
// bf16 — the full-width path — runs the chunked SSD on the tensor cores
// (ssd_wgmma_kernel<NP>).  Over chunks of 64 steps, with la = dt·a and cum
// its running sum inside the chunk (cum_Q its last value):
//     y_intra = (C·Bᵀ ⊙ exp(cum_i − cum_j)[j ≤ i] ⊙ dt_j) @ x
//     y_inter = exp(cum_i) ⊙ (C @ Hᵀ)
//     H'      = exp(cum_Q)·H + xᵀ @ (B ⊙ dt_j·exp(cum_Q − cum_j))
// The decay is formed from the difference cum_i − cum_j and selected for
// j ≤ i (above the diagonal the exp overflows; it is never multiplied in).
// Every product has an exact bf16 operand on one side: C·Bᵀ takes bf16 C
// and B as they are (exact in f32 accumulators); each f32 factor is folded
// into the other side, which is split into two bf16 parts, hi = bf16(v)
// and lo = bf16(v − hi) (about 16 significant bits): the masked decay
// matrix against x, the state against C, B ⊙ dt·decay against xᵀ.  One
// rounding of those would move y by about 2^-9 of its size, past the f32
// limit the checks hold.
//
// What bounds it: at zamba2-2.7b's SSD (2 × 80 heads, S 2048, P 64, N 64)
// the inputs and output are 86 MB, 0.026 ms at 3.35 TB/s; the products
// above, splits included, are 18.6 GFLOP, 0.019 ms at 989 TFLOP/s of bf16
// tensor cores.  The chunks of one (b, h) form a chain through H, so the
// design is one block of one warpgroup (128 threads) per (64 columns of P,
// head, batch row) — 160 blocks at zamba2, all resident at once (two fit
// an SM) — that loops over the chunks with H in registers:
//   * thread 0 loads each chunk's x (4 boxes of 16 columns of P), B and C
//     (N/16 boxes each) by TMA (32-byte swizzle, 4-D / 3-D tensor maps on
//     the caller's strides, rows past S read as zeros) into a two-stage
//     ring, two chunks ahead; warp 0 fetches dt one chunk ahead and scans
//     la with shuffles;
//   * wgmma: C·Bᵀ (ss, both K-major) and C·H_hiᵀ + C·H_loᵀ (ss, H written
//     back to shared memory by the threads as two bf16 parts); the masked
//     decay matrix in f32 registers, split into the two A operands of
//     M·x (rs, x MN-major); B ⊙ dt·decay written by the threads as two
//     bf16 parts, and H += xᵀ·W_hi + xᵀ·W_lo (ss, both MN-major);
//   * y + D·x rounded once and stored from the accumulator, rows < S.
// The chunk length (64, wgmma's M) changes the float order only; the
// wrapper's `chunk` is not read.  N pads to a multiple of 16 with zeros.
// What holds it at zamba2 (PERF.md §6): one warpgroup runs each chunk's
// steps in turn (the decay's exps, then the wgmmas that wait on them), so
// the time goes to latency along that chain, not to bytes or tensor-core
// work; computing the chunks' states in parallel and passing them along in
// a second step would break the chain.
//
// f32 (phase 16's reduced parity; no full-width path) keeps the step
// recurrence on the CUDA cores (ssd_kernel): 5·P·N f32 operations a step,
// about a third of the chunked form's products, which is the cheaper form
// without tensor cores.  What bounds it is those operations, under a chain
// of seq dependent steps.  Grid (P / 32, H, Bt) of 128 threads: a thread
// keeps 2 rows × N/8 columns of the state in registers and 8 threads a row
// pair sum y with shuffles; 32 steps (16 at N = 128) of x, dt, exp(dt·a),
// B and C are staged in shared memory, the next ones fetched into
// registers while the current ones run.  Each step uses
// fused multiply-adds where the reference rounds twice; the tolerance of
// the tests says so.  Holding f32 accuracy on the tensor cores needs a
// three-part split or 3xTF32, which is not done.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// element strides of the five strided tensors, as the wrapper passes them
struct Strides {
  int64_t xb, xh, xs;   // x (Bt, H, S, P), P contiguous
  int64_t db, dh, ds;   // dt (Bt, H, S)
  int64_t bb, bs;       // B (Bt, S, N), N contiguous
  int64_t cb, cs;       // C (Bt, S, N), N contiguous
  int64_t yb, yh, ys;   // y (Bt, H, S, P), P contiguous
};

// ---- f32: the step recurrence on the CUDA cores ------------------------------
constexpr int kThreads = 128;
constexpr int kGroups = 8;       // threads sharing one row pair's N columns
constexpr int kRowsPer = 2;      // state rows a thread owns
constexpr int kTileP = kThreads / kGroups * kRowsPer;   // rows of P a block owns
// steps staged in shared memory at a time (16 at N = 128, whose staged B
// and C would otherwise spill registers)
template <int N>
constexpr int kSteps = N > 64 ? 16 : 32;

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const float* __restrict__ B,
           const float* __restrict__ C, const float* __restrict__ d_skip,
           float* __restrict__ y, Strides st, int seq, int p_dim) {
  constexpr int kSt = kSteps<N>;
  constexpr int kCols = N / kGroups;              // state columns a thread owns
  constexpr int kPerBC = kSt * N / kThreads;      // staged B (and C) per thread
  constexpr int kPerX = kSt * kTileP / kThreads;  // staged x per thread
  __shared__ __align__(16) float bs[kSt * N];
  __shared__ __align__(16) float cs[kSt * N];
  __shared__ float xs[kSt * kTileP];
  __shared__ float dts[kSt], als[kSt];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, g = tid % kGroups, pr = tid / kGroups;
  const int p0 = tile * kTileP;
  const float* xb = x + b * st.xb + h * st.xh;
  float* yb = y + b * st.yb + h * st.yh;
  const float* dtb = dt + b * st.db + h * st.dh;
  const float* bb = B + b * st.bb;
  const float* cb = C + b * st.cb;
  const float a = -expf(a_log[h]);
  const float dsk = d_skip[h];

  float sv[kRowsPer][kCols];
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j)
#pragma unroll
    for (int i = 0; i < kCols; ++i) sv[j][i] = 0.f;

  // the next stage, fetched into registers: staged element tid + j·kThreads
  // is step tid / N + j·(kThreads / N), column tid % N of B and C, and step
  // tid / kTileP + j·(kThreads / kTileP), row p0 + tid % kTileP of x
  static_assert(kThreads % N == 0 && kThreads % kTileP == 0, "staging");
  float pb[kPerBC], pc[kPerBC], px[kPerX], pdt = 0.f;
  const int tb = tid / N, tx = tid / kTileP, px_col = p0 + tid % kTileP;
  auto fetch = [&](int t0) {
    const float* bp = bb + (t0 + tb) * st.bs + tid % N;
    const float* cp = cb + (t0 + tb) * st.cs + tid % N;
#pragma unroll
    for (int j = 0; j < kPerBC; ++j) {
      const bool in = t0 + tb + j * (kThreads / N) < seq;
      pb[j] = in ? *bp : 0.f;
      pc[j] = in ? *cp : 0.f;
      bp += (kThreads / N) * st.bs;
      cp += (kThreads / N) * st.cs;
    }
    const float* xp = xb + (t0 + tx) * st.xs + px_col;
#pragma unroll
    for (int j = 0; j < kPerX; ++j) {
      px[j] = t0 + tx + j * (kThreads / kTileP) < seq && px_col < p_dim
                  ? *xp : 0.f;
      xp += (kThreads / kTileP) * st.xs;
    }
    if (tid < kSt) pdt = t0 + tid < seq ? dtb[(t0 + tid) * st.ds] : 0.f;
  };
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < kPerBC; ++j) {
      bs[tid + j * kThreads] = pb[j];
      cs[tid + j * kThreads] = pc[j];
    }
#pragma unroll
    for (int j = 0; j < kPerX; ++j) xs[tid + j * kThreads] = px[j];
    if (tid < kSt) {
      dts[tid] = pdt;
      als[tid] = expf(pdt * a);
    }
  };

  fetch(0);
  put();
  __syncthreads();
  for (int t0 = 0; t0 < seq; t0 += kSt) {
    const bool more = t0 + kSt < seq;
    if (more) fetch(t0 + kSt);
    const int n = min(kSt, seq - t0);
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
          sv[j][i] = fmaf(xdt, bv[i], sv[j][i] * al);
          acc = fmaf(sv[j][i], cv[i], acc);
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
          if (p < p_dim) yb[(t0 + t) * st.ys + p] = yv[j] + xv[j] * dsk;
        }
      }
    }
    __syncthreads();               // every thread is done with this stage
    if (more) put();
    __syncthreads();
  }
}

template <int N>
int launch_f32_n(const void* x, const float* dt, const float* a_log,
                 const void* B, const void* C, const float* d_skip, void* y,
                 const Strides& st, int bt, int h, int seq, int p_dim,
                 cudaStream_t stream) {
  const dim3 grid((p_dim + kTileP - 1) / kTileP, h, bt);
  ssd_kernel<N><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), dt, a_log, static_cast<const float*>(B),
      static_cast<const float*>(C), d_skip, static_cast<float*>(y), st, seq,
      p_dim);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: the chunked form on the tensor cores ------------------------------
namespace tc {

constexpr int kQ = 64;           // steps of a chunk: wgmma's M
constexpr int kPT = 64;          // columns of P a block owns
constexpr int kThreads = 128;    // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;   // exp(x) = exp2(x·log2 e)

// Shared memory, every tile a multiple of 1 KB from a 1 KB-aligned base:
// two stages of (x, B, C), the state's two bf16 parts, W's two parts, then
// cum and dt of the chunk (f32) and the two stages' mbarriers.
template <int NP>
struct Layout {
  static_assert(NP % 16 == 0, "B and C load in boxes of 16 columns");
  static constexpr uint32_t kX = kQ * kPT * 2;       // x: 4 chunks of 16 P
  static constexpr uint32_t kBC = kQ * NP * 2;       // B or C: NP/16 chunks
  static constexpr uint32_t kStage = kX + 2 * kBC;
  static constexpr uint32_t kH = kPT * NP * 2;       // one part of H (K-major)
  static constexpr uint32_t kW = kQ * NP * 2;        // one part of W (MN-major)
  static constexpr uint32_t kCum = 2 * kStage + 2 * kH + 2 * kW;
  static constexpr size_t kBytes = 1024 + kCum + 2 * kQ * 4 + 2 * 8;
};

__device__ __forceinline__ uint32_t bits(const __nv_bfloat162& v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (hi, lo) bf16 pairs of two f32 values: hi = bf16(v), lo = bf16(v − hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tcm,
                 const float* __restrict__ dt,
                 const float* __restrict__ a_log,
                 const float* __restrict__ d_skip,
                 __nv_bfloat16* __restrict__ y, Strides st, int seq,
                 int p_dim) {
  using hopper::desc_sw32;
  using L = Layout<NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t s_base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_hhi = s_base + 2 * L::kStage, s_hlo = s_hhi + L::kH;
  const uint32_t s_whi = s_hlo + L::kH, s_wlo = s_whi + L::kW;
  const uint32_t s_bar = s_base + L::kCum + 2 * kQ * 4;
  float* cum_s = reinterpret_cast<float*>(smem_raw + (s_base + L::kCum -
                                                      hopper::smem_u32(smem_raw)));
  float* dt_s = cum_s + kQ;

  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  const int n_chunks = (seq + kQ - 1) / kQ;
  const float a = -expf(a_log[h]);
  const float dsk = d_skip[h];
  const float* dtb = dt + b * st.db + h * st.dh;

  auto issue = [&](int c, int stage) {
    const uint32_t sx = s_base + stage * L::kStage;
    const uint32_t bar = s_bar + 8 * stage;
    hopper::mbar_expect_tx(bar, L::kStage);
#pragma unroll
    for (int q = 0; q < kPT / 16; ++q)
      hopper::tma_load_4d(sx + q * kQ * 32, &tx, bar, p0 + 16 * q, c * kQ, h,
                          b);
#pragma unroll
    for (int k = 0; k < NP / 16; ++k) {
      hopper::tma_load_3d(sx + L::kX + k * kQ * 32, &tb, bar, 16 * k, c * kQ,
                          b);
      hopper::tma_load_3d(sx + L::kX + L::kBC + k * kQ * 32, &tcm, bar,
                          16 * k, c * kQ, b);
    }
  };
  // warp 0 holds dt of rows lane and lane + 32 of a chunk (0 past S)
  auto load_dt = [&](int c, float (&v)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = c * kQ + lane + 32 * r;
      v[r] = t < seq ? dtb[t * st.ds] : 0.f;
    }
  };

  if (tid == 0) {
    hopper::mbar_init(s_bar, 1);
    hopper::mbar_init(s_bar + 8, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    issue(0, 0);
    if (n_chunks > 1) issue(1, 1);
  }
  float dtn[2] = {0.f, 0.f};
  if (warp == 0) load_dt(0, dtn);

  float hs[NP / 2];              // H: rows p (64), columns n (NP)
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) hs[i] = 0.f;
  float cbm[32], yv[32];         // C·Bᵀ, then y: rows i, columns j / p

  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    const uint32_t parity = (c >> 1) & 1;
    const uint32_t sx = s_base + stage * L::kStage;
    const uint32_t sb = sx + L::kX, sc = sb + L::kBC;

    // warp 0: cum, the inclusive running sum of la over the chunk's rows
    if (warp == 0) {
      const float d0 = dtn[0], d1 = dtn[1];
      if (c + 1 < n_chunks) load_dt(c + 1, dtn);
      float s0 = d0 * a, s1 = d1 * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, s0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, s1, o);
        if (lane >= o) {
          s0 += u0;
          s1 += u1;
        }
      }
      s1 += __shfl_sync(0xffffffffu, s0, 31);
      cum_s[lane] = s0;
      cum_s[lane + 32] = s1;
      dt_s[lane] = d0;
      dt_s[lane + 32] = d1;
    }

    // CB = C·Bᵀ and, after the first chunk, C·Hᵀ from H's two parts
#pragma unroll
    for (int i = 0; i < 32; ++i) cbm[i] = yv[i] = 0.f;
    hopper::mbar_wait(s_bar + 8 * stage, parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < NP / 16; ++k)
      hopper::Wgmma<kQ>::ss(cbm, desc_sw32(sc + k * kQ * 32, 16, 256),
                            desc_sw32(sb + k * kQ * 32, 16, 256), 1);
    if (c > 0) {
#pragma unroll
      for (int k = 0; k < NP / 16; ++k)
        hopper::Wgmma<kPT>::ss(yv, desc_sw32(sc + k * kQ * 32, 16, 256),
                               desc_sw32(s_hhi + k * kPT * 32, 16, 256), 1);
#pragma unroll
      for (int k = 0; k < NP / 16; ++k)
        hopper::Wgmma<kPT>::ss(yv, desc_sw32(sc + k * kQ * 32, 16, 256),
                               desc_sw32(s_hlo + k * kPT * 32, 16, 256), 1);
    }
    hopper::wgmma_commit();
    __syncthreads();             // cum and dt are in shared memory
    hopper::wgmma_wait<0>();
    hopper::fence_operand(cbm);
    hopper::fence_operand(yv);

    // y_inter ⊙ exp(cum_i); the masked decay matrix as two bf16 A operands
    const float cum_r[2] = {cum_s[row0], cum_s[row0 + 8]};
    if (c > 0) {
      const float in_r[2] = {exp2f(cum_r[0] * kLog2e),
                             exp2f(cum_r[1] * kLog2e)};
#pragma unroll
      for (int i = 0; i < 32; ++i) yv[i] *= in_r[(i / 2) % 2];
    }
    uint32_t m_hi[16], m_lo[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int r = t % 2, i = row0 + 8 * r, j = 8 * (t / 2) + col0;
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        m[e] = j + e <= i ? cbm[2 * t + e] *
                                exp2f((cum_r[r] - cum_s[j + e]) * kLog2e) *
                                dt_s[j + e]
                          : 0.f;
      split2(m[0], m[1], m_hi[t], m_lo[t]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      const uint64_t dx = desc_sw32(sx + kk * 16 * 32, kQ * 32, 256);
      hopper::Wgmma<kPT>::rs(yv, m_hi + 4 * kk, dx, 1);
      hopper::Wgmma<kPT>::rs(yv, m_lo + 4 * kk, dx, 1);
    }
    hopper::wgmma_commit();

    // W = B ⊙ dt_j·exp(cum_Q − cum_j) as two bf16 parts, in B's layout:
    // thread tid owns row tid / 2, half tid % 2 of every 16-column chunk
    const float cum_q = cum_s[kQ - 1];
    {
      const int row = tid / 2;
      const float sj = dt_s[row] * exp2f((cum_q - cum_s[row]) * kLog2e);
#pragma unroll
      for (int k = 0; k < NP / 16; ++k) {
        const uint32_t off = k * kQ * 32 + tid * 16;
        uint4 raw;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
                     : "r"(sb + off));
        const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&in[e]));
          split2(v.x * sj, v.y * sj, hi[e], lo[e]);
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         s_whi + off),
                     "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3])
                     : "memory");
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         s_wlo + off),
                     "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3])
                     : "memory");
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();             // W is in shared memory

    // H = exp(cum_Q)·H + xᵀ·W_hi + xᵀ·W_lo (xᵀ and W both MN-major)
    const float tot = exp2f(cum_q * kLog2e);
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) hs[i] *= tot;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      const uint64_t dxt = desc_sw32(sx + kk * 16 * 32, kQ * 32, 256);
      hopper::Wgmma<NP>::template ss<1, 1>(
          hs, dxt, desc_sw32(s_whi + kk * 16 * 32, kQ * 32, 256), 1);
      hopper::Wgmma<NP>::template ss<1, 1>(
          hs, dxt, desc_sw32(s_wlo + kk * 16 * 32, kQ * 32, 256), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(yv);
    hopper::fence_operand(hs);

    // y + D·x, rows < S and columns < P, rounded once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r, t = c * kQ + i;
      if (t < seq) {
        __nv_bfloat16* yrow = y + b * st.yb + h * st.yh + t * st.ys + p0;
#pragma unroll
        for (int j = 0; j < kPT / 8; ++j) {
          const int p = 8 * j + col0;
          if (p0 + p < p_dim) {
            uint32_t raw;
            asm volatile("ld.shared.b32 %0, [%1];\n"
                         : "=r"(raw)
                         : "r"(sx + hopper::sw32_offset(kQ, i, p)));
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw));
            *reinterpret_cast<__nv_bfloat162*>(yrow + p) =
                __floats2bfloat162_rn(yv[4 * j + 2 * r] + dsk * xv.x,
                                      yv[4 * j + 2 * r + 1] + dsk * xv.y);
          }
        }
      }
    }

    // H's two bf16 parts for the next chunk's C·Hᵀ (K-major: rows p)
    if (c + 1 < n_chunks) {
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off =
              hopper::sw32_offset(kPT, row0 + 8 * r, 8 * j + col0);
          uint32_t hi, lo;
          split2(hs[4 * j + 2 * r], hs[4 * j + 2 * r + 1], hi, lo);
          st_shared_u32(s_hhi + off, hi);
          st_shared_u32(s_hlo + off, lo);
        }
      }
      hopper::fence_proxy_async();
    }
    __syncthreads();             // stage and H parts read by every warp
    if (tid == 0 && c + 2 < n_chunks) issue(c + 2, stage);
  }
}

}  // namespace tc

template <int NP>
int launch_bf16_n(const void* x, const float* dt, const float* a_log,
                  const void* B, const void* C, const float* d_skip, void* y,
                  const Strides& st, int bt, int h, int seq, int p_dim, int n,
                  cudaStream_t stream) {
  using L = tc::Layout<NP>;
  // x as (P, S, H, Bt) on its own strides, whatever their order (the
  // model's (Bt, S, H, P) memory has the head stride below the step's)
  const uint64_t u_s = static_cast<uint64_t>(seq);
  const uint64_t xdims[4] = {static_cast<uint64_t>(p_dim), u_s,
                             static_cast<uint64_t>(h),
                             static_cast<uint64_t>(bt)};
  const uint64_t xstr[3] = {static_cast<uint64_t>(st.xs) * 2,
                            static_cast<uint64_t>(st.xh) * 2,
                            static_cast<uint64_t>(st.xb) * 2};
  const uint32_t q = tc::kQ;
  const uint32_t xbox[4] = {16, q, 1, 1};
  const uint64_t bdims[3] = {static_cast<uint64_t>(n), u_s,
                             static_cast<uint64_t>(bt)};
  const uint64_t bstr[2] = {static_cast<uint64_t>(st.bs) * 2,
                            static_cast<uint64_t>(st.bb) * 2};
  const uint64_t cstr[2] = {static_cast<uint64_t>(st.cs) * 2,
                            static_cast<uint64_t>(st.cb) * 2};
  const uint32_t bbox[3] = {16, q, 1};
  CUtensorMap tx, tb, tcm;
  if (!hopper_host::bf16_map_sw32_strided(&tx, x, 4, xdims, xstr, xbox) ||
      !hopper_host::bf16_map_sw32_strided(&tb, B, 3, bdims, bstr, bbox) ||
      !hopper_host::bf16_map_sw32_strided(&tcm, C, 3, bdims, cstr, bbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      tc::ssd_wgmma_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p_dim + tc::kPT - 1) / tc::kPT, h, bt);
  tc::ssd_wgmma_kernel<NP><<<grid, tc::kThreads, L::kBytes, stream>>>(
      tx, tb, tcm, dt, a_log, d_skip, static_cast<__nv_bfloat16*>(y), st,
      seq, p_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and y (bt, h, seq, p), B and C (bt, seq, n), one dtype (1 = bf16, 0 =
// f32), each with its last dimension contiguous; dt (bt, h, seq), A_log and
// D (h,) f32.  `strides` holds 13 element strides: x (b, h, s), dt (b, h,
// s), B (b, s), C (b, s), y (b, h, s).  bf16: x, B and C 16-byte aligned
// with every stride a multiple of 8 elements.  n in {8, 16, 32, 64, 128}.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take).
extern "C" int repro_mamba_ssd_scan(const void* x, const float* dt,
                                    const float* a_log, const void* B,
                                    const void* C, const float* d_skip,
                                    void* y, const int64_t* strides, int bt,
                                    int h, int seq, int p, int n, int bf16,
                                    void* stream) {
  if (bt < 1 || bt > 65535 || h < 1 || h > 65535 || seq < 1 || p < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11],
                   strides[12]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (n) {
      case 8:
      case 16:
        return launch_bf16_n<16>(x, dt, a_log, B, C, d_skip, y, st, bt, h,
                                 seq, p, n, s);
      case 32:
        return launch_bf16_n<32>(x, dt, a_log, B, C, d_skip, y, st, bt, h,
                                 seq, p, n, s);
      case 64:
        return launch_bf16_n<64>(x, dt, a_log, B, C, d_skip, y, st, bt, h,
                                 seq, p, n, s);
      case 128:
        return launch_bf16_n<128>(x, dt, a_log, B, C, d_skip, y, st, bt, h,
                                  seq, p, n, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#define REPRO_SSD(NN)                                                      \
  case NN:                                                                 \
    return launch_f32_n<NN>(x, dt, a_log, B, C, d_skip, y, st, bt, h, seq, \
                            p, s)
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
