// One-query decode attention over a KV cache, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//   flash_decode        (B5, :99)  — _kernel (:30): q (B, H, 1, hd) over a
//       cache (B, KV, S, hd) read through its strides (the reference's
//       contiguous (B, KV, S, hd) form, or the (B, S, KV, hd) layer cache
//       of the models' decode step, in place), one scalar position `pos`
//       (read from device memory, as the Pallas kernel reads its
//       scalar-prefetch operand, or passed as a launch argument);
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
// Both are split-key decodes over thread-block clusters:
//   * One cluster of C blocks (C in {1, 2, 4, 8}, chosen by the wrapper
//     from the grid, the SM count and the cache length — and for B5 the
//     window — never from pos: few rows × heads get a wide split) per
//     (row, KV head, group of up to kRep query heads).  The row's live
//     keys [lo, hi] are cut into stages of 8 keys a warp and the stages
//     into C contiguous shares, each block cutting its own share on the
//     card; a block whose share is empty keeps m = −inf.  Each block
//     serves every query head of its group from the same staged keys, so
//     with GQA a K/V row is read from device memory once, not n_rep times.
//   * Each block stages K and V rows in shared memory through a ring of
//     stages filled by cp.async (16 bytes a thread and copy; keys past the
//     share are zero-filled), and computes on one stage while the next
//     ones land (cp.async groups, one __syncthreads a stage).
//   * A warp takes 8 keys of a stage at once, 4 lanes a key: each lane
//     holds a quarter of the dot products of its key with every query head
//     of the group (rows read as 16-byte chunks, bf16 widened to f32 after
//     the stage), 2 shuffles finish them.  So 8 keys' products are in
//     flight at once, and the online-softmax step — max over the 8 keys,
//     exp, rescale — runs once per 8 keys.  Then lane l adds p·v for dims
//     l + 32·e of the 8 keys.
//   * After the key loop the cluster's partial softmax states (m, l, acc)
//     are merged by the leader block (rank 0) through distributed shared
//     memory (map_shared_rank), which writes the output; a second cluster
//     barrier keeps every block's shared memory alive until the leader has
//     read it.  One launch, no global workspace.
//
// B5 (dense::decode_kernel<KT, kRep, kE>) reads key j of (row b, KV head g)
// at element b·sb + g·sg + j·sj of the cache (StridedRows), so the models'
// (B, S, KV, hd) layer cache is read where it lies, one row stride a key,
// with no transposed copy.  It reads `pos` through a pointer when one is
// given, so its launch arguments are the same at every decode step (a
// captured step replays at any position); q's loads are issued before
// pos's, and the first stages before q is stored, so their latencies
// overlap.  A block has 8 warps (4 for f32 rows of more than 128 dims):
// a stage's work is a chain of dependent steps in each warp, and a block
// streams its share as fast as its warps' chains allow.  It is compiled
// for each kE = ceil(hd / 32) (hd any multiple of 16 up to 256), so every
// loop over a row runs as far as hd needs and no further; when hd is no
// multiple of 32 (zamba2-2.7b's 80) a bf16 row is no whole number of the
// 4 lanes' 16-byte chunks and the last 32-dim column of p·v is partial,
// and only the last chunk and column check their lanes.  Its ring is
// sized by hd (2-4 stages of about kRingTarget bytes), and a staged row's
// pitch is padded so that the two keys a quarter-warp reads start 64
// bytes apart modulo 128 (other banks).  Each block first merges its
// warps' states in its own shared memory, so the leader merges C states,
// not C per warp; a block alone in its cluster (C = 1, launched without a
// cluster) writes the output itself.
//
// B6 (paged::paged_kernel<QT, KT, kRep>) reads each key through the page
// table (the page id read from the table and clamped per key), with 4
// warps a block, a fixed 3-stage ring and the chunk order rotating with
// the key; its leader merges every warp's state of the cluster.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// cp.async and the reads of staged rows, shared by B5 and B6
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

// B5: element offset of key j of (row b, kv head g) in a cache read
// through its strides (the last dimension contiguous); the key stride fits
// 32 bits, so a key's offset is one 32 x 32 -> 64-bit multiply-add (a
// 64 x 64-bit product in the key loop made the kernel measurably slower)
struct StridedRows {
  int64_t sb, sg;
  int sj;
};

// ---- B5: the split-key decode over a strided cache ---------------------------
namespace dense {

namespace cg = cooperative_groups;

constexpr int kKeysPerWarp = 8;            // 4 lanes a key
constexpr int kMinStages = 2, kMaxStages = 4;       // the cp.async ring
constexpr int kRingTarget = 65536;         // bytes a block's ring aims at
constexpr int kMaxE = 8;                   // hd / 32 <= 8
constexpr int kMaxSmem = 232448;           // an H100 block's shared memory

// Warps a block, 8 keys each a stage: 8, or 4 for f32 rows of more than
// 128 dims (two 64-key stages of those would not fit a block).  Twice the
// warps of a 4-warp block stream a block's share twice as fast: a stage's
// work is a chain of dependent steps per warp, and a block is as fast as
// its warps' chains allow.
__host__ __device__ constexpr int block_warps(int esz, int n_e) {
  return esz == 4 && n_e > 4 ? 4 : 8;
}
// Bytes from one staged row to the next: the row padded so that rows
// start 64 bytes apart modulo 128 (a row is a multiple of 32 bytes).  A
// quarter-warp reads two keys' 64 contiguous bytes, which then fall in the
// two halves of the banks.
__host__ __device__ inline int row_pitch(int hd, int esz) {
  const int row = hd * esz;
  return row + (192 - row % 128) % 128;
}
__host__ __device__ inline int stage_bytes(int pitch, int warps) {
  return 2 * kKeysPerWarp * warps * pitch;   // K rows, then V rows
}
// stages of the ring: as many as fit kRingTarget, 2 to 4
__host__ __device__ inline int ring_stages(int pitch, int warps) {
  const int n = kRingTarget / stage_bytes(pitch, warps);
  return n < kMinStages ? kMinStages : n > kMaxStages ? kMaxStages : n;
}
__host__ __device__ inline size_t q_bytes(int rep, int hd) {
  return (static_cast<size_t>(rep) * hd * 4 + 15) / 16 * 16;
}
// Shared memory: the group's q (f32, scaled), then the ring; after the key
// loop the ring's bytes hold each warp's (m, l, acc), then the block's.
__host__ __device__ inline size_t smem_bytes(int rep, int hd, int esz) {
  const int warps = block_warps(esz, (hd + 31) / 32);
  const int pitch = row_pitch(hd, esz);
  const size_t ring = static_cast<size_t>(ring_stages(pitch, warps)) *
                      stage_bytes(pitch, warps);
  const size_t parts = static_cast<size_t>(warps + 1) * rep * (hd + 2) * 4;
  return q_bytes(rep, hd) + (ring > parts ? ring : parts);
}

// kE = ceil(hd / 32): the 32-dim columns of p·v a lane holds, so every
// loop over a row runs exactly as far as hd needs.  When hd is no multiple
// of 32 the last column is partial and a bf16 row's 16-byte chunks are no
// multiple of the 4 lanes of a key: lanes check their dim and chunk in the
// last column and chunk only.
template <typename KT, int kRep, int kE>
__global__ void __launch_bounds__(32 * block_warps(sizeof(KT), kE))
decode_kernel(const void* __restrict__ q, const KT* __restrict__ kc,
              const KT* __restrict__ vc, void* __restrict__ out,
              StridedRows rows, const int* __restrict__ pos_dev, int pos_arg,
              int n_heads, int n_rep, int n_groups, int hd, int n_keys,
              int window, float scale, int q_bf16) {
  constexpr int kWarps = block_warps(sizeof(KT), kE);
  constexpr int kThreads = 32 * kWarps;
  constexpr int kStageKeys = kKeysPerWarp * kWarps;   // keys a stage
  constexpr int kElems = 16 / sizeof(KT);     // elements of a 16-byte chunk
  constexpr int kI = 8 * kE / kElems;          // chunks a lane reads, at most
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int g = blockIdx.y / n_groups, grp = blockIdx.y % n_groups;
  const int b = blockIdx.z;
  const int h0 = g * n_rep + grp * kRep;
  const int nh = min(kRep, n_rep - grp * kRep);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pitch = row_pitch(hd, sizeof(KT));
  const int pitch_e = pitch / static_cast<int>(sizeof(KT));
  const int n_stages = ring_stages(pitch, kWarps);
  const int st_bytes = stage_bytes(pitch, kWarps);

  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + q_bytes(kRep, hd);
  const uint32_t ring_u32 =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  // q's elements of this thread, read before pos so that the two loads'
  // latencies overlap (q goes to shared memory once the first stages are
  // in flight)
  constexpr int kQPer = (kRep * 32 * kE + kThreads - 1) / kThreads;
  float qr[kQPer];
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = tid + u * kThreads, hh = i / hd;
    qr[u] = 0.f;
    if (i < kRep * hd && hh < nh) {
      const int64_t e =
          (static_cast<int64_t>(b) * n_heads + h0 + hh) * hd + i % hd;
      qr[u] = q_bf16 ? widen1(static_cast<const __nv_bfloat16*>(q) + e)
                     : widen1(static_cast<const float*>(q) + e);
    }
  }

  // the live keys and this block's share of their stages, cut on the card
  const int pos = pos_dev != nullptr ? __ldg(pos_dev) : pos_arg;
  const int hi = min(pos, n_keys - 1);
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int n_live = hi - lo + 1;
  const int n_st = n_live > 0 ? (n_live + kStageKeys - 1) / kStageKeys : 0;
  const int per = (n_st + n_split - 1) / n_split;
  const int st0 = min(n_st, rank * per), st1 = min(n_st, st0 + per);

  const int row_chunks = hd / kElems;          // 16-byte chunks of a row
  const int64_t head = b * rows.sb + g * rows.sg;
  auto load = [&](int st, int slot) {
    const int base = lo + st * kStageKeys;
    const uint32_t k_dst = ring_u32 + static_cast<uint32_t>(slot * st_bytes);
    const uint32_t v_dst = k_dst + static_cast<uint32_t>(kStageKeys * pitch);
    for (int i = tid; i < kStageKeys * row_chunks; i += kThreads) {
      const int kk = i / row_chunks, c = i - kk * row_chunks;
      const int j = base + kk;
      const KT* ks = kc;
      const KT* vs = vc;
      int bytes = 0;
      if (j <= hi) {
        const int64_t off =
            head + static_cast<int64_t>(j) * rows.sj + c * kElems;
        ks += off;
        vs += off;
        bytes = 16;
      }
      const uint32_t o = static_cast<uint32_t>(kk * pitch + c * 16);
      cp_async16(k_dst + o, ks, bytes);            // 0 bytes: zero-filled
      cp_async16(v_dst + o, vs, bytes);
    }
  };

  // per warp and head: the running max, sum and f32 hd-vector
  float m[kRep], l[kRep], acc[kRep][kE];
#pragma unroll
  for (int hh = 0; hh < kRep; ++hh) {
    m[hh] = -INFINITY;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[hh][e] = 0.f;
  }
  const int kk = warp * kKeysPerWarp + (lane >> 2), part = lane & 3;
  // lane l holds dims l + 32·e; in the last column only the lanes below hd
  const bool last = lane + 32 * (kE - 1) < hd;

  for (int i = 0; i < n_stages - 1; ++i) {
    if (st0 + i < st1) load(st0 + i, i);
    cp_async_commit();
  }
  // q, once the first stages are in flight (the loop's first barrier
  // publishes it)
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = tid + u * kThreads;
    if (i < kRep * hd) q_s[i] = qr[u] * scale;
  }
  for (int st = st0; st < st1; ++st) {
    // stage st landed once at most n_stages - 2 younger groups are pending
    if (n_stages == 4) cp_async_wait<2>();
    else if (n_stages == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();             // stage st landed; stage st - 1 is free
    {
      const int nx = st + n_stages - 1;
      if (nx < st1) load(nx, (nx - st0) % n_stages);
      cp_async_commit();
    }
    const int slot = (st - st0) % n_stages;
    const KT* k_s = reinterpret_cast<const KT*>(ring + slot * st_bytes);
    const KT* v_s = k_s + kStageKeys * pitch_e;
    const int j = lo + st * kStageKeys + kk;

    // this lane's quarter of q·k for every head of the group
    float sc[kRep];
#pragma unroll
    for (int hh = 0; hh < kRep; ++hh) sc[hh] = 0.f;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int c = part + 4 * i;
      if (i < kI - 1 || c < row_chunks) {
        float x[8];
        widen(k_s + kk * pitch_e + c * kElems, x);
#pragma unroll
        for (int hh = 0; hh < kRep; ++hh) {
          const float* qc = q_s + hh * hd + c * kElems;
#pragma unroll
          for (int t = 0; t < kElems; ++t) sc[hh] = fmaf(qc[t], x[t], sc[hh]);
        }
      }
    }
    const bool valid = j <= hi;
    float p[kRep];
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
      float alpha = 1.f;
      p[hh] = 0.f;
      if (m_new != -INFINITY) {                   // else no key yet
        p[hh] = valid ? expf(v - m_new) : 0.f;
        alpha = expf(m[hh] - m_new);              // 0 on the first key
      }
      float ps = p[hh];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[hh] = l[hh] * alpha + ps;
      m[hh] = m_new;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[hh][e] *= alpha;
    }
    // acc += p·v over the warp's 8 keys; lane l holds dims l + 32·e
#pragma unroll
    for (int k = 0; k < kKeysPerWarp; ++k) {
      const KT* vrow = v_s + (warp * kKeysPerWarp + k) * pitch_e + lane;
      float vv[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e)
        vv[e] = e < kE - 1 || last ? widen1(vrow + 32 * e) : 0.f;
#pragma unroll
      for (int hh = 0; hh < kRep; ++hh) {
        const float pk = __shfl_sync(0xffffffffu, p[hh], 4 * k);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[hh][e] = fmaf(pk, vv[e], acc[hh][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();               // the ring's bytes now hold the states

  float* part_m = reinterpret_cast<float*>(ring);              // [warp][head]
  float* part_l = part_m + kWarps * kRep;
  float* part_acc = part_l + kWarps * kRep;                    // [warp][head][hd]
  float* blk_m = part_acc + kWarps * kRep * hd;                // [head]
  float* blk_l = blk_m + kRep;
  float* blk_acc = blk_l + kRep;                               // [head][hd]
#pragma unroll
  for (int hh = 0; hh < kRep; ++hh) {
    if (lane == 0) {
      part_m[warp * kRep + hh] = m[hh];
      part_l[warp * kRep + hh] = l[hh];
    }
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (e < kE - 1 || last)
        part_acc[(warp * kRep + hh) * hd + lane + 32 * e] = acc[hh][e];
  }
  __syncthreads();
  auto put = [&](int hh, int d, float o) {
    const int64_t at = (static_cast<int64_t>(b) * n_heads + h0 + hh) * hd + d;
    if (q_bf16) store(static_cast<__nv_bfloat16*>(out) + at, o);
    else store(static_cast<float*>(out) + at, o);
  };
  // this block's state: its warps' states merged (alone in its cluster,
  // the block writes the output itself)
  for (int i = tid; i < kRep * hd; i += kThreads) {
    const int hh = i / hd, d = i - hh * hd;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, part_m[w * kRep + hh]);
    float a = 0.f, lb = 0.f;
    if (mb != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(part_m[w * kRep + hh] - mb);
        a = fmaf(wt, part_acc[(w * kRep + hh) * hd + d], a);
        lb = fmaf(wt, part_l[w * kRep + hh], lb);
      }
    }
    if (n_split == 1) {
      if (hh < nh) put(hh, d, lb > 0.f ? a / lb : 0.f);
      continue;
    }
    blk_acc[i] = a;
    if (d == 0) {
      blk_m[hh] = mb;
      blk_l[hh] = lb;
    }
  }
  if (n_split == 1) return;
  cluster.sync();                // every block's state is in place

  if (rank == 0) {
    for (int i = tid; i < nh * hd; i += kThreads) {
      const int hh = i / hd, d = i - hh * hd;
      float m_all = -INFINITY;
      for (int r = 0; r < n_split; ++r)
        m_all = fmaxf(m_all, *cluster.map_shared_rank(blk_m + hh, r));
      float num = 0.f, den = 0.f;
      if (m_all != -INFINITY) {                  // no key in range: zeros
        for (int r = 0; r < n_split; ++r) {
          const float wt =
              expf(*cluster.map_shared_rank(blk_m + hh, r) - m_all);
          num = fmaf(wt, *cluster.map_shared_rank(blk_acc + i, r), num);
          den = fmaf(wt, *cluster.map_shared_rank(blk_l + hh, r), den);
        }
      }
      put(hh, d, den > 0.f ? num / den : 0.f);
    }
  }
  cluster.sync();                // the leader is done reading
}

template <typename KT, int kRep, int kE>
int launch(const void* q, const void* k, const void* v, void* out,
           StridedRows rows, const int* pos_dev, int pos_arg, int n_rows,
           int n_heads, int kv_heads, int hd, int n_keys, int window,
           float scale, int q_bf16, int n_split, cudaStream_t stream) {
  const int n_rep = n_heads / kv_heads;
  const int n_groups = (n_rep + kRep - 1) / kRep;
  const size_t smem = smem_bytes(kRep, hd, sizeof(KT));
  auto kernel = decode_kernel<KT, kRep, kE>;
  // the most any hd asks (227 KB), set once: a decode step launches this
  // every layer, and the host's time a call is what a step waits on
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
  cfg.gridDim = dim3(n_split, kv_heads * n_groups, n_rows);
  cfg.blockDim = dim3(32 * block_warps(sizeof(KT), kE));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_split > 1;    // C = 1: a plain launch (a cluster of one)
  err = cudaLaunchKernelEx(&cfg, kernel, q, static_cast<const KT*>(k),
                           static_cast<const KT*>(v), out, rows, pos_dev,
                           pos_arg, n_heads, n_rep, n_groups, hd, n_keys,
                           window, scale, q_bf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT, int kRep>
int by_columns(const void* q, const void* k, const void* v, void* out,
               StridedRows rows, const int* pos_dev, int pos_arg, int n_rows,
               int n_heads, int kv_heads, int hd, int n_keys, int window,
               float scale, int q_bf16, int n_split, cudaStream_t stream) {
#define REPRO_DENSE(E)                                                        \
  case E:                                                                     \
    return launch<KT, kRep, E>(q, k, v, out, rows, pos_dev, pos_arg, n_rows,  \
                               n_heads, kv_heads, hd, n_keys, window, scale,  \
                               q_bf16, n_split, stream)
  switch ((hd + 31) / 32) {
    REPRO_DENSE(1); REPRO_DENSE(2); REPRO_DENSE(3); REPRO_DENSE(4);
    REPRO_DENSE(5); REPRO_DENSE(6); REPRO_DENSE(7); REPRO_DENSE(8);
  }
#undef REPRO_DENSE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KT>
int dispatch(const void* q, const void* k, const void* v, void* out,
             StridedRows rows, const int* pos_dev, int pos_arg, int n_rows,
             int n_heads, int kv_heads, int hd, int n_keys, int window,
             float scale, int q_bf16, int n_split, cudaStream_t stream) {
  const int n_rep = n_heads / kv_heads;
#define REPRO_DENSE(R)                                                        \
  return by_columns<KT, R>(q, k, v, out, rows, pos_dev, pos_arg, n_rows,      \
                           n_heads, kv_heads, hd, n_keys, window, scale,      \
                           q_bf16, n_split, stream)
  if (n_rep == 1) REPRO_DENSE(1);
  if (n_rep == 2) REPRO_DENSE(2);
  if (n_rep <= 4) REPRO_DENSE(4);
  REPRO_DENSE(8);
#undef REPRO_DENSE
}

}  // namespace dense


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
// dimensions, the last one contiguous, every row 16-byte aligned; hd a
// multiple of 16 up to 256; dtypes by flag (1 = bf16, 0 = f32).  The
// position is *pos_dev when pos_dev is not null, else pos.  n_split: the
// blocks of a cluster (1, 2, 4 or 8) that share each row's keys.  Returns
// cudaGetLastError().
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  void* out, int b, int h, int kv, int seq,
                                  int hd, int pos, const int* pos_dev,
                                  int window, float scale, int q_bf16,
                                  int kv_bf16, long long sb, long long sg,
                                  long long sj, int n_split, void* stream) {
  const long long esz = kv_bf16 ? 2 : 4;
  const uintptr_t misaligned =
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16;
  if (hd < 16 || hd > 32 * dense::kMaxE || hd % 16 != 0 || kv < 1 ||
      h % kv != 0 || b < 1 || b > 65535 || seq < 1 ||
      kv * ((h / kv + 7) / 8) > 65535 || sj < 1 || sj > INT32_MAX ||
      misaligned || (sb * esz) % 16 || (sg * esz) % 16 || (sj * esz) % 16 ||
      (n_split != 1 && n_split != 2 && n_split != 4 && n_split != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const StridedRows rows{sb, sg, static_cast<int>(sj)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DENSE(KT)                                                      \
  return dense::dispatch<KT>(q, k, v, out, rows, pos_dev, pos, b, h, kv, hd, \
                             seq, window, scale, q_bf16, n_split, s)
  if (kv_bf16) REPRO_DENSE(__nv_bfloat16);
  REPRO_DENSE(float);
#undef REPRO_DENSE
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
