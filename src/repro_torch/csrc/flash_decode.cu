// One-query decode attention over a KV cache, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//   flash_decode        (B5, :99)  — _kernel (:30): q (B, H, 1, hd) over a
//       contiguous cache (B, KV, S, hd), one scalar position `pos`;
//   flash_decode_paged  (B6, :192) — _paged_kernel (:149): q (S, H, 1, hd)
//       over a page pool (P, page_len, KV, hd) through a page table (S, PP)
//       int32 and per-row lengths (S,) int32.
// Both compute, per (row, query head h) with KV head g = h / n_rep,
//     o = softmax_j(q·k_j · hd^-0.5) · v_j   over the keys j with
//     j <= pos (and j > pos − window when window > 0),
// in f32, whatever the cache dtype (f32 or bf16) and q dtype (f32 or bf16);
// the output has q's dtype, rounded to nearest even.  One templated kernel
// serves both: only the addressing of key j differs (ContigRows, PagedRows).
//
// Page ids are clamped to [0, P − 1] before they are read: the serving
// engine marks unowned table entries with the sentinel P (one past the
// pool), and the plain version reads through a gather that clamps as JAX's
// does, so a dead row (all sentinel, length 0) attends to position 0 of
// page P − 1 in both and the kernel never reads past the pool.  Only keys
// inside [lo, hi] = [max(0, pos − window + 1), min(pos, n_keys − 1)] are
// visited, so pages past the row's length or wholly before its window cost
// nothing.  Callers keep 0 <= pos < n_keys (the engine does); a row with no
// key in range (pos < 0) gets zeros, where the plain softmax over an
// all-masked row would average every position.
//
// What bounds it: device-memory bytes.  Each visited key costs 2·hd
// elements of K and V (4 or 2 bytes each) for 4·hd flops; q and the output
// are small.  At the phi3-mini decode shape (8 rows × 32 heads, hd 96,
// lengths up to 1023, f32 pages) that is about 100 MB, some 30 µs at the
// 3.35 TB/s of an H100 SXM, against ~25 Mflop.  The design therefore
// streams K and V once and keeps the rest on chip:
//   * one block of 32 warps per (row, query head); the warps take pairs
//     of consecutive keys in turn, so every warp has 2·kKeys·hd/32
//     independent loads in flight per step.  The per-key work (dot
//     product, shuffles, exp, rescale) is a dependent chain, so many warps
//     with few keys each hide its latency better than few warps with many
//     keys (tried on the H100: 8 to 32 warps × 2 to 8 keys), and at 64
//     registers a thread two such blocks fill an SM;
//   * a warp splits hd over its lanes (lane l holds dims l + 32·e, so a key
//     row is read by coalesced 128-byte (f32) or 64-byte (bf16) segments),
//     warp-reduces the kKeys dot products with shuffles, and keeps a running
//     max, sum and f32 hd-vector (the online softmax);
//   * at the end the warps' (max, sum, vector) merge in shared memory.
// The TPU kernel's (block, page) grid with its scratch carried across grid
// steps has no place here: blocks run in parallel, so the loop over keys
// lives inside the block.  With GQA each KV head is read by its n_rep
// query heads' blocks (through L2).  wgmma, TMA and a split over keys come
// later; at a few rows × heads the grid is smaller than two waves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;      // a 1024-thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 2;        // keys a warp carries per step
constexpr int kMaxE = 8;        // hd / 32 <= 8, i.e. hd <= 256

// one element as f32, through the read-only cache; a bf16 element is read as
// its 16 raw bits and widened exactly (bf16 is the top half of an f32)
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

// B5: cache (B, KV, S, hd); element offset of key j of (row b, kv head g)
struct ContigRows {
  int kv_heads, seq, hd;
  __device__ __forceinline__ int64_t offset(int b, int g, int j) const {
    return ((static_cast<int64_t>(b) * kv_heads + g) * seq + j) * hd;
  }
};

// B6: pool (P, page_len, KV, hd) through table (rows, pages_per_slot)
struct PagedRows {
  const int* table;
  int pages_per_slot, page_len, n_pages, kv_heads, hd;
  __device__ __forceinline__ int64_t offset(int b, int g, int j) const {
    int page = table[static_cast<int64_t>(b) * pages_per_slot + j / page_len];
    page = min(max(page, 0), n_pages - 1);           // JAX gather's clamp
    return ((static_cast<int64_t>(page) * page_len + j % page_len) * kv_heads
            + g) * hd;
  }
};

template <typename QT, typename KT, class Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
              const KT* __restrict__ vc, QT* __restrict__ out, Rows rows,
              const int* __restrict__ lengths, int pos_all, int n_heads,
              int n_rep, int hd, int n_keys, int window, float scale) {
  const int h = blockIdx.x, b = blockIdx.y, g = h / n_rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_e = hd >> 5;
  const int pos = lengths != nullptr ? lengths[b] : pos_all;
  const int hi = min(pos, n_keys - 1);
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;

  const QT* qrow = q + (static_cast<int64_t>(b) * n_heads + h) * hd;
  float qf[kMaxE], acc[kMaxE];
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    qf[e] = e < n_e ? load_f32(qrow, lane + 32 * e) * scale : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int base = lo + warp * kKeys; base <= hi; base += kWarps * kKeys) {
    float kf[kKeys][kMaxE], vf[kKeys][kMaxE];
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      const bool live = base + c <= hi;
      const int64_t off = live ? rows.offset(b, g, base + c) : 0;
#pragma unroll
      for (int e = 0; e < kMaxE; ++e) {
        const bool on = live && e < n_e;
        kf[c][e] = on ? load_f32(kc, off + lane + 32 * e) : 0.f;
        vf[c][e] = on ? load_f32(vc, off + lane + 32 * e) : 0.f;
      }
    }
    float s[kKeys];
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxE; ++e) d += qf[e] * kf[c][e];
      s[c] = d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < kKeys; ++c)
        s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
    }
    float m_new = m;
#pragma unroll
    for (int c = 0; c < kKeys; ++c)
      if (base + c <= hi) m_new = fmaxf(m_new, s[c]);
    const float alpha = expf(m - m_new);        // 0 on the first step
    float p[kKeys], p_sum = 0.f;
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      p[c] = base + c <= hi ? expf(s[c] - m_new) : 0.f;
      p_sum += p[c];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      float a = acc[e] * alpha;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) a += p[c] * vf[c][e];
      acc[e] = a;
    }
    m = m_new;
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][32 * kMaxE];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < kMaxE; ++e)
    if (e < n_e) sm_acc[warp][lane + 32 * e] = acc[e];
  __syncthreads();
  float m_all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
  QT* orow = out + (static_cast<int64_t>(b) * n_heads + h) * hd;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float num = 0.f, den = 0.f;
    if (m_all != -INFINITY) {               // no key in range: zeros
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(sm_m[w] - m_all);
        num += wt * sm_acc[w][d];
        den += wt * sm_l[w];
      }
    }
    store(orow + d, den > 0.f ? num / den : 0.f);
  }
}

template <class Rows>
int launch(const void* q, const void* k, const void* v, void* out, Rows rows,
           const int* lengths, int pos, int n_rows, int n_heads,
           int kv_heads, int hd, int n_keys, int window, float scale,
           int q_bf16, int kv_bf16, cudaStream_t stream) {
  if (hd < 32 || hd > 32 * kMaxE || hd % 32 != 0 || kv_heads < 1 ||
      n_heads % kv_heads != 0 || n_rows < 1 || n_rows > 65535 ||
      n_keys < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_heads, n_rows);
  const int n_rep = n_heads / kv_heads;
  using bf16 = __nv_bfloat16;
#define REPRO_DECODE(QT, KT)                                                \
  decode_kernel<QT, KT, Rows><<<grid, kThreads, 0, stream>>>(               \
      static_cast<const QT*>(q), static_cast<const KT*>(k),                 \
      static_cast<const KT*>(v), static_cast<QT*>(out), rows, lengths, pos, \
      n_heads, n_rep, hd, n_keys, window, scale)
  if (q_bf16 && kv_bf16) REPRO_DECODE(bf16, bf16);
  else if (q_bf16) REPRO_DECODE(bf16, float);
  else if (kv_bf16) REPRO_DECODE(float, bf16);
  else REPRO_DECODE(float, float);
#undef REPRO_DECODE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B5.  q (b, h, 1, hd), k/v (b, kv, seq, hd), out like q; dtypes by flag
// (1 = bf16, 0 = f32).  Returns cudaGetLastError().
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  void* out, int b, int h, int kv, int seq,
                                  int hd, int pos, int window, float scale,
                                  int q_bf16, int kv_bf16, void* stream) {
  return launch(q, k, v, out, ContigRows{kv, seq, hd}, nullptr, pos, b, h,
                kv, hd, seq, window, scale, q_bf16, kv_bf16,
                static_cast<cudaStream_t>(stream));
}

// B6.  q (rows, h, 1, hd), k/v pages (n_pages, page_len, kv, hd), table
// (rows, pages_per_slot) int32, lengths (rows,) int32, out like q.
extern "C" int repro_flash_decode_paged(
    const void* q, const void* k, const void* v, const int* table,
    const int* lengths, void* out, int rows, int h, int kv, int hd,
    int page_len, int pages_per_slot, int n_pages, int window, float scale,
    int q_bf16, int kv_bf16, void* stream) {
  if (page_len < 1 || pages_per_slot < 1 || n_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, out,
                PagedRows{table, pages_per_slot, page_len, n_pages, kv, hd},
                lengths, 0, rows, h, kv, hd, page_len * pages_per_slot,
                window, scale, q_bf16, kv_bf16,
                static_cast<cudaStream_t>(stream));
}
