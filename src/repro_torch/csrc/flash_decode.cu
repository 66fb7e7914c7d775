// One-query decode attention over a KV cache, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//   flash_decode        (B5, :99)  — _kernel (:30): q (B, H, 1, hd) over a
//       cache (B, KV, S, hd) read through its strides (the reference's
//       contiguous (B, KV, S, hd) form, or the (B, S, KV, hd) layer cache
//       of the models' decode step, in place), one scalar position `pos`;
//   flash_decode_paged  (B6, :192) — _paged_kernel (:149): q (S, H, 1, hd)
//       over a page pool (P, page_len, KV, hd) through a page table (S, PP)
//       int32 and per-row lengths (S,) int32.
// Both compute, per (row, query head h) with KV head g = h / n_rep,
//     o = softmax_j(q·k_j · hd^-0.5) · v_j   over the keys j with
//     j <= pos (and j > pos − window when window > 0),
// in f32, whatever the cache dtype (f32 or bf16) and q dtype (f32 or bf16);
// the output has q's dtype, rounded to nearest even.
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
// lengths up to 1023, f32 pages) that is about 124 MB, some 37 µs at the
// 3.35 TB/s of an H100 SXM, against ~25 Mflop.  Both designs therefore
// stream K and V once and keep the rest on chip.
//
// B5 (decode_kernel<QT, KT, kTail>): one block of 32 warps per (row, query
// head); the warps take pairs of consecutive keys in turn with plain
// global loads, a warp splits hd over its lanes (lane l holds dims
// l + 32·e: coalesced rows; when hd is a multiple of 16 but not of 32 —
// zamba2-2.7b's 80 — the lanes past hd in the last chunk hold zeros and
// load nothing, a per-lane check compiled in only then, kTail: in every
// chunk it made the bf16 kernel measurably slower),
// warp-reduces the dot products with shuffles and keeps a running max, sum
// and f32 hd-vector (the online softmax); at the end the warps' states
// merge in shared memory.  Key j of (row b, KV head g) starts at element
// b·sb + g·sg + j·sj of the cache (StridedRows), so the models' (B, S, KV,
// hd) layer cache is read where it lies, one row stride per key, with no
// transposed copy.  With GQA each KV head is read by its n_rep query
// heads' blocks, through L2.
//
// B6 (paged_kernel): a split-key decode over thread-block clusters.
//   * One cluster of C blocks (C in {1, 2, 4, 8}, chosen by the wrapper
//     from the grid: few rows × heads get a wide split) per (row, KV head,
//     group of up to kRep query heads).  The row's live keys [lo, hi] are
//     cut into stages of kStageKeys keys and the stages into C contiguous
//     shares; a block whose share is empty keeps m = −inf.  Each block
//     serves every query head of its group from the same staged keys, so
//     with GQA a page is read from device memory once, not n_rep times.
//   * Each block (4 warps) stages K and V rows in shared memory through a
//     ring of kStages stages filled by cp.async (16 bytes a thread and
//     copy, the page id read from the table and clamped per key; keys past
//     the share are zero-filled), and computes on one stage while the next
//     two land (cp.async groups, one __syncthreads a stage).
//   * A warp takes 8 keys of a stage at once, 4 lanes a key: each lane
//     holds a quarter of the dot products of its key with every query head
//     of the group (rows read as 16-byte chunks, bf16 widened to f32 after
//     the stage; the chunk order rotates with the key so the 8 keys of a
//     quarter-warp fall in different banks), 2 shuffles finish them.  So 8
//     keys' products are in flight at once, and the online-softmax step —
//     max over the 8 keys, exp, rescale — runs once per 8 keys, where the
//     B5 design waits on a chain per key pair.  Then lane l adds p·v for
//     dims l + 32·e of the 8 keys.
//   * Each warp leaves (m, l, acc) per head in its block's shared memory;
//     after a cluster barrier the leader block (rank 0) reads the C blocks'
//     states through distributed shared memory (map_shared_rank), merges
//     them and writes the output; a second barrier keeps every block's
//     shared memory alive until the leader has read it.  One launch, no
//     global workspace.
#include <cooperative_groups.h>
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

// B5: element offset of key j of (row b, kv head g) in a cache read
// through its strides (the last dimension contiguous); the key stride fits
// 32 bits, so a key's offset is one 32 x 32 -> 64-bit multiply-add (a
// 64 x 64-bit product in the key loop made the kernel measurably slower)
struct StridedRows {
  int64_t sb, sg;
  int sj;
  __device__ __forceinline__ int64_t offset(int b, int g, int j) const {
    return b * sb + g * sg + static_cast<int64_t>(j) * sj;
  }
};

// kTail: hd is no multiple of 32, so the last 32-dim chunk is partial and
// each lane checks that its dim exists (the other chunks' guard stays
// uniform across the warp)
template <typename QT, typename KT, bool kTail>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
              const KT* __restrict__ vc, QT* __restrict__ out, StridedRows rows,
              int pos, int n_heads, int n_rep, int hd, int n_keys, int window,
              float scale) {
  const int h = blockIdx.x, b = blockIdx.y, g = h / n_rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hi = min(pos, n_keys - 1);
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int n_e = (hd + 31) >> 5;   // chunks of 32 dims: lane l holds l + 32·e
  const bool tail = !kTail || lane + 32 * (n_e - 1) < hd;
  auto has = [&](int e) { return e < n_e && (e < n_e - 1 || tail); };

  const QT* qrow = q + (static_cast<int64_t>(b) * n_heads + h) * hd;
  float qf[kMaxE], acc[kMaxE];
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    qf[e] = has(e) ? load_f32(qrow, lane + 32 * e) * scale : 0.f;
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
        const bool on = live && has(e);
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
    if (has(e)) sm_acc[warp][lane + 32 * e] = acc[e];
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

int launch(const void* q, const void* k, const void* v, void* out,
           StridedRows rows, int pos, int n_rows, int n_heads, int kv_heads,
           int hd, int n_keys, int window, float scale, int q_bf16,
           int kv_bf16, cudaStream_t stream) {
  if (hd < 16 || hd > 32 * kMaxE || hd % 16 != 0 || kv_heads < 1 ||
      n_heads % kv_heads != 0 || n_rows < 1 || n_rows > 65535 ||
      n_keys < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_heads, n_rows);
  const int n_rep = n_heads / kv_heads;
  using bf16 = __nv_bfloat16;
#define REPRO_DECODE_TAIL(QT, KT, TAIL)                                     \
  decode_kernel<QT, KT, TAIL><<<grid, kThreads, 0, stream>>>(               \
      static_cast<const QT*>(q), static_cast<const KT*>(k),                 \
      static_cast<const KT*>(v), static_cast<QT*>(out), rows, pos, n_heads, \
      n_rep, hd, n_keys, window, scale)
#define REPRO_DECODE(QT, KT)                                                \
  do {                                                                      \
    if (hd % 32) REPRO_DECODE_TAIL(QT, KT, true);                           \
    else REPRO_DECODE_TAIL(QT, KT, false);                                  \
  } while (0)
  if (q_bf16 && kv_bf16) REPRO_DECODE(bf16, bf16);
  else if (q_bf16) REPRO_DECODE(bf16, float);
  else if (kv_bf16) REPRO_DECODE(float, bf16);
  else REPRO_DECODE(float, float);
#undef REPRO_DECODE
#undef REPRO_DECODE_TAIL
  return static_cast<int>(cudaGetLastError());
}


// ---- B6: the split-key paged decode over a cluster ---------------------------
namespace paged {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;                  // a 128-thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kKeysPerWarp = 8;            // 4 lanes a key
constexpr int kStageKeys = kWarps * kKeysPerWarp;   // keys a stage
constexpr int kStages = 3;                 // the cp.async ring
constexpr int kMaxE = 8;                   // hd / 32 <= 8
constexpr int kMaxSmem = 232448;           // an H100 block's shared memory

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the 4 (f32) or 8 (bf16) elements of one 16-byte chunk as f32
__device__ __forceinline__ void widen(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ float widen1(const float* p) { return *p; }
__device__ __forceinline__ float widen1(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Shared memory: the group's q (f32, scaled), then the ring of K and V
// stages; after the key loop the stages' bytes hold each warp's (m, l, acc).
template <typename KT, int kRep>
struct Smem {
  __host__ __device__ static size_t q_bytes(int hd) { return static_cast<size_t>(kRep) * hd * 4; }
  __host__ __device__ static size_t stage_bytes(int hd) {
    return static_cast<size_t>(kStageKeys) * hd * sizeof(KT);
  }
  __host__ __device__ static size_t bytes(int hd) {
    const size_t ring = 2 * kStages * stage_bytes(hd);
    const size_t parts = static_cast<size_t>(kWarps) * kRep * (hd + 2) * 4;
    return q_bytes(hd) + (ring > parts ? ring : parts);
  }
};

template <typename QT, typename KT, int kRep>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
             const KT* __restrict__ vp, QT* __restrict__ out,
             const int* __restrict__ table, const int* __restrict__ lengths,
             int pages_per_slot, int page_len, int n_pages, int n_heads,
             int kv_heads, int n_rep, int n_groups, int hd, int window,
             float scale) {
  constexpr int kElems = 16 / sizeof(KT);     // elements of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int g = blockIdx.y / n_groups, grp = blockIdx.y % n_groups;
  const int b = blockIdx.z;
  const int h0 = g * n_rep + grp * kRep;
  const int nh = min(kRep, n_rep - grp * kRep);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_e = hd >> 5;

  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + Smem<KT, kRep>::q_bytes(hd);
  const size_t stage_bytes = Smem<KT, kRep>::stage_bytes(hd);
  const uint32_t ring_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  for (int i = tid; i < kRep * hd; i += kThreads) {
    const int hh = i / hd;
    q_s[i] = hh < nh ? widen1(q + (static_cast<int64_t>(b) * n_heads + h0 + hh)
                                      * hd + i % hd) * scale
                     : 0.f;
  }

  const int n_keys = pages_per_slot * page_len;
  const int pos = lengths[b];
  const int hi = min(pos, n_keys - 1);
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int n_live = hi - lo + 1;
  const int n_st = n_live > 0 ? (n_live + kStageKeys - 1) / kStageKeys : 0;
  const int per = (n_st + n_split - 1) / n_split;
  const int st0 = min(n_st, rank * per), st1 = min(n_st, st0 + per);

  const int row_chunks = hd / kElems;          // 16-byte chunks of a row
  const int64_t row_stride = static_cast<int64_t>(kv_heads) * hd;
  const int* trow = table + static_cast<int64_t>(b) * pages_per_slot;
  auto load = [&](int st, int slot) {
    const int base = lo + st * kStageKeys;
    const uint32_t k_dst = ring_u32 + static_cast<uint32_t>(2 * slot * stage_bytes);
    const uint32_t v_dst = k_dst + static_cast<uint32_t>(stage_bytes);
    for (int i = tid; i < kStageKeys * row_chunks; i += kThreads) {
      const int kk = i / row_chunks, c = i - kk * row_chunks;
      const int j = base + kk;
      const KT* ks = kp;
      const KT* vs = vp;
      int bytes = 0;
      if (j <= hi) {
        int page = trow[j / page_len];
        page = min(max(page, 0), n_pages - 1);     // JAX gather's clamp
        const int64_t off =
            (static_cast<int64_t>(page) * page_len + j % page_len) * row_stride
            + static_cast<int64_t>(g) * hd + c * kElems;
        ks += off;
        vs += off;
        bytes = 16;
      }
      const uint32_t o = static_cast<uint32_t>((kk * row_chunks + c) * 16);
      cp_async16(k_dst + o, ks, bytes);            // 0 bytes: zero-filled
      cp_async16(v_dst + o, vs, bytes);
    }
  };

  // per warp and head: the running max, sum and f32 hd-vector
  float m[kRep], l[kRep], acc[kRep][kMaxE];
#pragma unroll
  for (int hh = 0; hh < kRep; ++hh) {
    m[hh] = -INFINITY;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) acc[hh][e] = 0.f;
  }
  const int kk = warp * kKeysPerWarp + (lane >> 2), part = lane & 3;
  const int n_i = row_chunks / 4;                 // chunks a lane reads

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (st0 + i < st1) load(st0 + i, i);
    cp_async_commit();
  }
  for (int st = st0; st < st1; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();             // stage st landed; stage st - 1 is free
    {
      const int nx = st + kStages - 1;
      if (nx < st1) load(nx, (nx - st0) % kStages);
      cp_async_commit();
    }
    const int slot = (st - st0) % kStages;
    const KT* k_s = reinterpret_cast<const KT*>(ring + 2 * slot * stage_bytes);
    const KT* v_s = reinterpret_cast<const KT*>(ring + (2 * slot + 1) * stage_bytes);
    const int j = lo + st * kStageKeys + kk;

    // this lane's quarter of q·k for every head of the group
    float sc[kRep];
#pragma unroll
    for (int hh = 0; hh < kRep; ++hh) sc[hh] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < n_i) {
        const int c = part + 4 * ((i + kk) % n_i);
        float x[8];
        widen(k_s + kk * hd + c * kElems, x);
#pragma unroll
        for (int hh = 0; hh < kRep; ++hh) {
          const float* qc = q_s + hh * hd + c * kElems;
#pragma unroll
          for (int t = 0; t < kElems; ++t) sc[hh] = fmaf(qc[t], x[t], sc[hh]);
        }
      }
    }
    const bool valid = j <= hi;
    float p[kRep], alpha[kRep];
#pragma unroll
    for (int hh = 0; hh < kRep; ++hh) {
      float v = sc[hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v = valid ? v : -INFINITY;
      float mx = v;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[hh], mx);
      if (m_new == -INFINITY) {                   // no key yet: nothing to add
        p[hh] = 0.f;
        alpha[hh] = 1.f;
      } else {
        p[hh] = valid ? expf(v - m_new) : 0.f;
        alpha[hh] = expf(m[hh] - m_new);          // 0 on the first key
      }
      float ps = p[hh];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[hh] = l[hh] * alpha[hh] + ps;
      m[hh] = m_new;
#pragma unroll
      for (int e = 0; e < kMaxE; ++e) acc[hh][e] *= alpha[hh];
    }
    // acc += p·v over the warp's 8 keys; lane l holds dims l + 32·e
#pragma unroll
    for (int k = 0; k < kKeysPerWarp; ++k) {
      const KT* vrow = v_s + (warp * kKeysPerWarp + k) * hd + lane;
      float vv[kMaxE];
#pragma unroll
      for (int e = 0; e < kMaxE; ++e) vv[e] = e < n_e ? widen1(vrow + 32 * e) : 0.f;
#pragma unroll
      for (int hh = 0; hh < kRep; ++hh) {
        const float pk = __shfl_sync(0xffffffffu, p[hh], 4 * k);
#pragma unroll
        for (int e = 0; e < kMaxE; ++e) acc[hh][e] = fmaf(pk, vv[e], acc[hh][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();               // the ring's bytes now hold the warps' states

  float* part_m = reinterpret_cast<float*>(ring);              // [warp][head]
  float* part_l = part_m + kWarps * kRep;
  float* part_acc = part_l + kWarps * kRep;                    // [warp][head][hd]
#pragma unroll
  for (int hh = 0; hh < kRep; ++hh) {
    if (lane == 0) {
      part_m[warp * kRep + hh] = m[hh];
      part_l[warp * kRep + hh] = l[hh];
    }
#pragma unroll
    for (int e = 0; e < kMaxE; ++e)
      if (e < n_e) part_acc[(warp * kRep + hh) * hd + lane + 32 * e] = acc[hh][e];
  }
  cluster.sync();                // every block's states are in place

  if (rank == 0) {
    for (int i = tid; i < nh * hd; i += kThreads) {
      const int hh = i / hd, d = i % hd;
      float m_all = -INFINITY;
      for (int r = 0; r < n_split; ++r) {
        const float* rm = cluster.map_shared_rank(part_m, r);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, rm[w * kRep + hh]);
      }
      float num = 0.f, den = 0.f;
      if (m_all != -INFINITY) {                  // no key in range: zeros
        for (int r = 0; r < n_split; ++r) {
          const float* rm = cluster.map_shared_rank(part_m, r);
          const float* rl = cluster.map_shared_rank(part_l, r);
          const float* ra = cluster.map_shared_rank(part_acc, r);
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            const float wt = expf(rm[w * kRep + hh] - m_all);
            num = fmaf(wt, ra[(w * kRep + hh) * hd + d], num);
            den = fmaf(wt, rl[w * kRep + hh], den);
          }
        }
      }
      store(out + (static_cast<int64_t>(b) * n_heads + h0 + hh) * hd + d,
            den > 0.f ? num / den : 0.f);
    }
  }
  cluster.sync();                // the leader is done reading
}

template <typename QT, typename KT, int kRep>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* table, const int* lengths, int rows, int n_heads,
           int kv_heads, int hd, int page_len, int pages_per_slot,
           int n_pages, int window, float scale, int n_split,
           cudaStream_t stream) {
  const int n_rep = n_heads / kv_heads;
  const int n_groups = (n_rep + kRep - 1) / kRep;
  const size_t smem = Smem<KT, kRep>::bytes(hd);
  auto kernel = paged_kernel<QT, KT, kRep>;
  // the most any hd asks (227 KB), set once: a decode tick launches this
  // every layer, and the host's time a call is what a tick waits on
  static bool opted_in = false;
  cudaError_t err;
  if (!opted_in) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, kv_heads * n_groups, rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const QT*>(q),
                           static_cast<const KT*>(k), static_cast<const KT*>(v),
                           static_cast<QT*>(out), table, lengths,
                           pages_per_slot, page_len, n_pages, n_heads,
                           kv_heads, n_rep, n_groups, hd, window, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const int* table, const int* lengths, int rows, int n_heads,
             int kv_heads, int hd, int page_len, int pages_per_slot,
             int n_pages, int window, float scale, int n_split,
             cudaStream_t stream) {
  const int n_rep = n_heads / kv_heads;
#define REPRO_PAGED(R)                                                        \
  return launch<QT, KT, R>(q, k, v, out, table, lengths, rows, n_heads,       \
                           kv_heads, hd, page_len, pages_per_slot, n_pages,   \
                           window, scale, n_split, stream)
  if (n_rep == 1) REPRO_PAGED(1);
  if (n_rep == 2) REPRO_PAGED(2);
  if (n_rep <= 4) REPRO_PAGED(4);
  REPRO_PAGED(8);
#undef REPRO_PAGED
}

}  // namespace paged

}  // namespace

// B5.  q (b, h, 1, hd) contiguous, out like q; k and v (b, kv, seq, hd)
// read through the element strides (sb, sg, sj) of their first three
// dimensions, the last one contiguous; hd a multiple of 16 up to 256;
// dtypes by flag (1 = bf16, 0 = f32).  Returns cudaGetLastError().
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  void* out, int b, int h, int kv, int seq,
                                  int hd, int pos, int window, float scale,
                                  int q_bf16, int kv_bf16, long long sb,
                                  long long sg, long long sj, void* stream) {
  if (sj < 1 || sj > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, out, StridedRows{sb, sg, static_cast<int>(sj)}, pos,
                b, h, kv, hd, seq, window, scale, q_bf16, kv_bf16,
                static_cast<cudaStream_t>(stream));
}

// B6.  q (rows, h, 1, hd), k/v pages (n_pages, page_len, kv, hd), table
// (rows, pages_per_slot) int32, lengths (rows,) int32, out like q; every
// tensor contiguous, the pools 16-byte aligned.  n_split: the blocks of a
// cluster (1, 2, 4 or 8) that share each row's keys.
extern "C" int repro_flash_decode_paged(
    const void* q, const void* k, const void* v, const int* table,
    const int* lengths, void* out, int rows, int h, int kv, int hd,
    int page_len, int pages_per_slot, int n_pages, int window, float scale,
    int q_bf16, int kv_bf16, int n_split, void* stream) {
  if (page_len < 1 || pages_per_slot < 1 || n_pages < 1 || hd < 32 ||
      hd > 32 * paged::kMaxE || hd % 32 != 0 || kv < 1 || h % kv != 0 ||
      rows < 1 || rows > 65535 || kv * ((h / kv + 7) / 8) > 65535 ||
      (n_split != 1 && n_split != 2 && n_split != 4 && n_split != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define REPRO_PAGED(QT, KT)                                                  \
  return paged::dispatch<QT, KT>(q, k, v, out, table, lengths, rows, h, kv,  \
                                 hd, page_len, pages_per_slot, n_pages,      \
                                 window, scale, n_split, s)
  if (q_bf16 && kv_bf16) REPRO_PAGED(bf16, bf16);
  if (q_bf16) REPRO_PAGED(bf16, float);
  if (kv_bf16) REPRO_PAGED(float, bf16);
  REPRO_PAGED(float, float);
#undef REPRO_PAGED
}
