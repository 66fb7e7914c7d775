// Causal + sliding-window GQA attention with an online softmax,
// hand-written for Hopper (sm_90a), in two forms chosen by dtype.
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (B4, :83; _kernel :28).  For each
// (b, query head h) with KV head g = h / n_rep:
//     o_i = Σ_j softmax_j(q_i·k_j · hd^-0.5) · v_j
// over the keys j < sk with, when causal, j <= p_i and (window > 0) p_i − j
// < window, where query i sits at position p_i = q_offset + i and keys
// count from 0 (q_offset 0, Sq = Sk: the prefill; q_offset = pos over a
// whole KV cache: a chunk behind it).  q_offset is a host int, or an int32
// the kernel reads in device memory (a decode step's position, which never
// reaches the host; the grid depends on the shapes only).  q (B, H, Sq,
// hd) contiguous; k and v (B, KV, Sk, hd) through their own element
// strides (the last dimension contiguous), so the (B, S, KV, hd) layer
// cache is read in place through its transpose(1, 2) view; all one dtype
// (f32 or bf16); scores, softmax and the product with v in f32; the
// output (B, H, Sq, hd) in q's dtype, rounded once.  Masked scores are −1e30, as the TPU kernel's, so a row
// whose keys in a visited tile are all masked behaves as there; keys past
// sk (a ragged last tile) are −inf and never count.  Key tiles wholly
// above the diagonal or before the window are never loaded: over a whole
// cache, a chunk at pos reads the tiles up to pos + Sq only.  Head dims
// 32, 64, 80, 96, 128 and 256; any Sq and Sk.
//
// bf16 — every full-width path — runs on the tensor cores
// (attention_wgmma_kernel).  What bounds it: the attention's operations at
// the dense bf16 rate.  At zamba2-2.7b's shared attention (2 × 32 heads,
// hd 80, S 2048, causal) the band is 43 GFLOP of Q·Kᵀ and P·V, 0.043 ms at
// 989 TFLOP/s, against 84 MB of q, k, v and output (0.025 ms at 3.35 TB/s).
// The design:
//   * one block of one warpgroup (128 threads) per (64-query tile, head,
//     batch row), the tiles with the most keys first (blockIdx.x counts
//     down); thread 0 loads by TMA (cp.async.bulk.tensor, 32-byte
//     swizzle, boxes of 16 columns, so hd 80 and 96 need no padding) the
//     Q tile once and K and V tiles of 64 keys into a two-stage ring,
//     each completing on its own mbarrier, so the next tile loads while
//     this one computes (64 keys rather than 128 leave room for two or
//     more blocks an SM at hd <= 96, whose softmax and wgmmas interleave);
//   * S = Q·Kᵀ in hd/16 wgmma k-steps on bf16 operands with f32
//     accumulators — each product of two bf16 values is exact in f32 —
//     then times hd^-0.5 in f32; the mask only on diagonal, window-edge
//     and ragged tiles;
//   * the online softmax on the accumulator in registers, exp as exp2f of
//     x·log2 e: a row lies across the 4 threads of a quad (two shuffles
//     for its max; the sums stay per thread until the end);
//   * P·V with P in f32 split into two bf16 parts, P_hi = bf16(P) and
//     P_lo = bf16(P − P_hi) (about 16 significant bits): two wgmmas with
//     A from registers — the accumulator layout of a 16-bit wgmma is its
//     A layout — against V as an MN-major B, into the f32 output
//     accumulator (64 × hd a warpgroup), rescaled first.  Rounding P to
//     bf16 once would move outputs by about 2^-9 of their size, beyond
//     the f32 limit the parity checks hold; the split costs 1.5x the
//     operations, still an order under the CUDA-core time.
//
// f32 (the parity checks and tests; no full-width path) keeps the
// CUDA-core kernel attention_kernel<float, HD>.  What bounds it: f32
// operations, 0.64 ms at 67 TFLOP/s for the zamba2 band.  One block of 256
// threads per 64-query tile; q·scale (f32, transposed) in shared memory;
// K tiles of 64 keys stream through one shared buffer, transposed, then V
// through the same buffer; a thread computes a 4 × 4 patch of the 64 × 64
// score tile (two float4 loads per 16 fused multiply-adds), the 16 threads
// of a row group reduce max and sum with shuffles, and it keeps 4 rows ×
// hd/16 columns (d = tx + 16·e) of the output in registers; p goes
// through shared memory (transposed) to the P·V product.  Holding f32
// accuracy on the tensor cores needs 3xTF32, which is not done yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

// element strides of k and v over (batch, KV head, key)
struct KvStrides {
  int64_t kb, kh, ks, vb, vh, vs;
};

// ---- f32: CUDA cores ---------------------------------------------------------
constexpr int kBq = 64, kBk = 64;   // query rows and keys of a tile
constexpr int kThreads = 256;       // 16 × 16: ty over rows, tx over keys
constexpr int kLd = kBq + 4;        // leading dim of Qᵀ, Kᵀ and Pᵀ (floats)
static_assert(kBq == kBk, "Qt, Kt and Pt share one leading dimension");

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
                 int host_offset, const int* __restrict__ dev_offset,
                 KvStrides st, float scale) {
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
  const T* kb = k + b * st.kb + g * st.kh;
  const T* vb = v + b * st.vb + g * st.vh;
  T* ob = out + (static_cast<int64_t>(b) * n_heads + h) * sq * HD;
  const int q_offset = dev_offset ? __ldg(dev_offset) : host_offset;

  for (int e = tid; e < kBq * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, row = q0 + r;
    qt[d * kLd + r] =
        row < sq ? load_f32(qb, static_cast<int64_t>(row) * HD + d) * scale
                 : 0.f;
  }

  // the key tiles some row of this query tile attends to (row r sits at
  // position q_offset + r)
  const int p0 = q_offset + q0;
  int kt_lo = 0, kt_hi = (sk + kBk - 1) / kBk - 1;
  if (causal) {
    kt_hi = min(kt_hi, (p0 + kBq - 1) / kBk);
    if (window > 0) kt_lo = max(0, p0 - window + 1) / kBk;
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
          key < sk ? load_f32(kb, key * st.ks + d) : 0.f;
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
      const int qpos = p0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        if (key >= sk)
          s[i][j] = -INFINITY;
        else if (causal &&
                 (key > qpos || (window > 0 && qpos - key >= window)))
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
      kv[e] = key < sk ? load_f32(vb, key * st.vs + e % HD) : 0.f;
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


// ---- bf16: tensor cores ------------------------------------------------------
namespace tc {

constexpr int kBq = 64;          // query rows of a block: one warpgroup
constexpr int kBk = 64;          // keys of a K / V tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;   // exp(x) = exp2(x·log2 e)

template <int HD>
struct Tile {
  static_assert(HD % 16 == 0, "K and V load in chunks of 16 columns");
  static constexpr int kChunks = HD / 16;
  static constexpr uint32_t kQBytes = kBq * HD * 2;
  static constexpr uint32_t kKvBytes = kBk * HD * 2;   // one K or V tile
  // Q, K[2], V[2] (each a multiple of 1 KB, from a 1 KB-aligned base), then
  // the mbarriers of Q, K[2] and V[2]; the first KB is slack for aligning
  static constexpr size_t kSmem = 1024 + kQBytes + 4 * kKvBytes + 5 * 8;
};

// expect the whole box's bytes on `bar`, then load rows [r0, r0 + Rows) of
// matrix `mat` as Chunks boxes of 16 columns, chunk c at dst + c·Rows·32
template <int Chunks, int Rows>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint32_t dst, uint32_t bar, int r0,
                                          int mat) {
  hopper::mbar_expect_tx(bar, Chunks * Rows * 32);
#pragma unroll
  for (int c = 0; c < Chunks; ++c)
    hopper::tma_load_3d(dst + c * Rows * 32, map, bar, 16 * c, r0, mat);
}

// the same for K or V rows [k0, k0 + Rows) of (KV head g, batch row b),
// through a 4-D map over the tensor's own strides
template <int Chunks, int Rows>
__device__ __forceinline__ void load_kv_tile(const CUtensorMap* map,
                                             uint32_t dst, uint32_t bar,
                                             int k0, int g, int b) {
  hopper::mbar_expect_tx(bar, Chunks * Rows * 32);
#pragma unroll
  for (int c = 0; c < Chunks; ++c)
    hopper::tma_load_4d(dst + c * Rows * 32, map, bar, 16 * c, k0, g, b);
}

__device__ __forceinline__ uint32_t bits(const __nv_bfloat162& x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out, int n_heads,
                       int kv_heads, int sq, int sk, int causal, int window,
                       int host_offset, const int* __restrict__ dev_offset,
                       float scale) {
  using hopper::desc_sw32;
  using W = Tile<HD>;
  constexpr int kChunks = W::kChunks;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t s_q = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + W::kQBytes;          // stage s at + s·kKvBytes
  const uint32_t s_v = s_k + 2 * W::kKvBytes;
  const uint32_t bar_q = s_v + 2 * W::kKvBytes;   // K[s] at + 8 + 8s,
                                                  // V[s] at + 24 + 8s

  const int qi = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (n_heads / kv_heads);
  const int q0 = qi * kBq;
  const int qmat = b * n_heads + h;
  const int q_offset = dev_offset ? __ldg(dev_offset) : host_offset;

  // the key tiles some row of this query tile attends to (row r sits at
  // position q_offset + r)
  const int p0 = q_offset + q0;
  int kt_lo = 0, kt_hi = (sk + kBk - 1) / kBk - 1;
  if (causal) {
    kt_hi = min(kt_hi, (p0 + kBq - 1) / kBk);
    if (window > 0) kt_lo = max(0, p0 - window + 1) / kBk;
  }
  const int n_tiles = kt_hi - kt_lo + 1;

  // this thread's rows row0 and row0 + 8, columns col0 + 8j (+1)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  float o[HD / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  if (n_tiles > 0) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 5; ++i) hopper::mbar_init(bar_q + 8 * i, 1);
      hopper::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      load_tile<kChunks, kBq>(&tq, s_q, bar_q, q0, qmat);
      for (int t = 0; t < 2 && t < n_tiles; ++t) {
        const int k0 = (kt_lo + t) * kBk;
        load_kv_tile<kChunks, kBk>(&tk, s_k + t * W::kKvBytes,
                                   bar_q + 8 + 8 * t, k0, g, b);
        load_kv_tile<kChunks, kBk>(&tv, s_v + t * W::kKvBytes,
                                   bar_q + 24 + 8 * t, k0, g, b);
      }
    }
    __syncwarp();
    hopper::mbar_wait(bar_q, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1;
      const uint32_t parity = (t >> 1) & 1;
      const int k0 = (kt_lo + t) * kBk;
      const uint32_t k_st = s_k + st * W::kKvBytes;
      const uint32_t v_st = s_v + st * W::kKvBytes;

      // S = Q·Kᵀ: one k-step per 16 columns of hd, both operands K-major
      float s[kBk / 2];
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) s[i] = 0.f;
      hopper::mbar_wait(bar_q + 8 + 8 * st, parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        hopper::Wgmma<kBk>::ss(s, desc_sw32(s_q + c * kBq * 32, 16, 256),
                               desc_sw32(k_st + c * kBk * 32, 16, 256),
                               c > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);

      // scale in f32; mask only a tile that holds a masked pair
      const bool edge =
          k0 + kBk > sk ||
          (causal && (k0 + kBk - 1 > p0 ||
                      (window > 0 && p0 + kBq - 1 - k0 >= window)));
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) {
        float x = s[i] * scale;
        if (edge) {
          const int qpos = q_offset + row0 + 8 * ((i / 2) % 2);
          const int key = k0 + 8 * (i / 4) + col0 + i % 2;
          if (key >= sk)
            x = -INFINITY;
          else if (causal &&
                   (key > qpos || (window > 0 && qpos - key >= window)))
            x = kNegInf;
        }
        s[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }

      // p = exp(s − m) in f32; the row sums take it whole, P·V as two bf16
      // parts.  Pair i (s[2i], s[2i + 1]) is A register i % 4 of k-step
      // i / 4, on row i % 2.
      uint32_t p_hi[kBk / 4], p_lo[kBk / 4];
#pragma unroll
      for (int i = 0; i < kBk / 4; ++i) {
        const int r = i % 2;
        const float a = exp2f((s[2 * i] - m[r]) * kLog2e);
        const float c = exp2f((s[2 * i + 1] - m[r]) * kLog2e);
        l[r] += a + c;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[i] = bits(hi);
        p_lo[i] = bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // O += P_hi·V + P_lo·V: one k-step per 16 keys, V MN-major (chunks of
      // 16 hd columns kBk·32 bytes apart, groups of 8 keys 256 bytes apart)
      hopper::mbar_wait(bar_q + 24 + 8 * st, parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        const uint64_t dv = desc_sw32(v_st + kk * 16 * 32, kBk * 32, 256);
        hopper::Wgmma<HD>::rs(o, p_hi + 4 * kk, dv, 1);
        hopper::Wgmma<HD>::rs(o, p_lo + 4 * kk, dv, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(o);

      __syncthreads();   // every warp is done with stage st: refill it
      if (tid == 0 && t + 2 < n_tiles) {
        const int kn = (kt_lo + t + 2) * kBk;
        load_kv_tile<kChunks, kBk>(&tk, k_st, bar_q + 8 + 8 * st, kn, g, b);
        load_kv_tile<kChunks, kBk>(&tv, v_st, bar_q + 24 + 8 * st, kn, g,
                                   b);
      }
      __syncwarp();
    }
  }

  // the quad's sums, then rows < sq divided by max(l, 1e-30), rounded once
  __nv_bfloat16* ob = out + static_cast<int64_t>(qmat) * sq * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row < sq) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = ob + static_cast<int64_t>(row) * HD + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
    }
  }
}

}  // namespace tc

template <int HD>
int launch_f32_hd(const void* q, const void* k, const void* v, void* out,
                  int b, int h, int kv, int sq, int sk, int causal,
                  int window, int q_offset, const int* dev_offset,
                  const KvStrides& st, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB a block's dynamic shared memory needs this opt-in (it
  // holds for the current device, so it is set at every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<float, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBq - 1) / kBq, h, b);
  attention_kernel<float, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), h, kv, sq, sk,
      causal, window, q_offset, dev_offset, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16_hd(const void* q, const void* k, const void* v, void* out,
                   int b, int h, int kv, int sq, int sk, int causal,
                   int window, int q_offset, const int* dev_offset,
                   const KvStrides& st, float scale, cudaStream_t stream) {
  using W = tc::Tile<HD>;
  // K and V as (hd, Sk, KV, B) on their own byte strides, whatever their
  // order (the layer cache's KV-head stride is below its key stride); keys
  // past sk read as zeros
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(sk),
                            static_cast<uint64_t>(kv),
                            static_cast<uint64_t>(b)};
  const uint64_t kstr[3] = {static_cast<uint64_t>(st.ks) * 2,
                            static_cast<uint64_t>(st.kh) * 2,
                            static_cast<uint64_t>(st.kb) * 2};
  const uint64_t vstr[3] = {static_cast<uint64_t>(st.vs) * 2,
                            static_cast<uint64_t>(st.vh) * 2,
                            static_cast<uint64_t>(st.vb) * 2};
  const uint32_t box[4] = {16, tc::kBk, 1, 1};
  CUtensorMap tq, tk, tv;
  if (!hopper_host::bf16_map_sw32(&tq, q, b * h, sq, HD, tc::kBq) ||
      !hopper_host::bf16_map_sw32_strided(&tk, k, 4, dims, kstr, box) ||
      !hopper_host::bf16_map_sw32_strided(&tv, v, 4, dims, vstr, box))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      tc::attention_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(W::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + tc::kBq - 1) / tc::kBq, h, b);
  tc::attention_wgmma_kernel<HD><<<grid, tc::kThreads, W::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), h, kv, sq, sk, causal,
      window, q_offset, dev_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q and out (b, h, sq, hd) contiguous, k and v (b, kv, sk, hd) on the six
// element strides of `strides` (k's batch, head, key, then v's; the last
// dimension contiguous), one dtype (1 = bf16, 0 = f32); bf16 pointers and
// byte strides multiples of 16.  hd in {32, 64, 80, 96, 128, 256}; h a
// multiple of kv.  Query i sits at position q_offset + i (keys count from
// 0), q_offset read from `dev_offset` (an int32 in device memory) when it
// is not null: q_offset 0 with sq == sk is the prefill, q_offset = pos over
// a whole cache a chunk behind it.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int h,
                                     int kv, int sq, int sk, int hd,
                                     int causal, int window, int q_offset,
                                     const int* dev_offset,
                                     const int64_t* strides, float scale,
                                     int bf16, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kv < 1 || h % kv != 0 ||
      sq < 1 || sk < 1 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const KvStrides st{strides[0], strides[1], strides[2],
                     strides[3], strides[4], strides[5]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ATTN(HH)                                                      \
  case HH:                                                                  \
    return bf16 ? launch_bf16_hd<HH>(q, k, v, out, b, h, kv, sq, sk,        \
                                     causal, window, q_offset, dev_offset,  \
                                     st, scale, s)                          \
                : launch_f32_hd<HH>(q, k, v, out, b, h, kv, sq, sk, causal, \
                                    window, q_offset, dev_offset, st,       \
                                    scale, s)
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
