// GQA decode attention against a ring KV cache, written by hand for Hopper
// (sm_90a). It replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (body _dec_kernel)
// and computes what that kernel computes: one new token's attention for the
// G = H / Hkv query rows that share a kv head, over a ring of W slots where
// slot i holds absolute position pos - ((pos - i) mod W) (floor-mod), masked
// to positions >= 0 and, with a sliding window, to pos - position < window.
// Masked scores are -1e30 (not -inf), the softmax runs online in float32 and
// the output takes q's dtype.
//
// What bounds it: the bytes of K and V. Each K or V element read feeds 2*G
// floating-point operations, a few per byte, while the card needs about 20
// float32 operations per byte of device memory before compute is the limit.
// At phi4-mini's ring (B 1, Hkv 8, W 4096, D 128, bf16) a call reads
// 16.8 MB, 5 us at 3.35 TB/s: about as long as a launch, so the call has to
// be one launch that keeps every SM's loads in flight from its start.
// What the design does about that:
//   * one launch: a grid of (batch x kv head, split, row chunk) blocks,
//     about one wave (the wrapper plans tile, rows and splits, see
//     ../decode_attention.py); a block works for up to four of the G query
//     rows of one kv head, which share every K and V row it reads (the
//     other chunks of a larger group re-read them from L2);
//   * the ring's tiles are dealt round-robin to the splits; a tile holds
//     `tile` slots (64, fewer for rows wider than 256 bytes, so a stage is
//     at most 32 KB), and its K rows and V rows are two contiguous runs,
//     each brought by one 1-D bulk copy (TMA) into a ring of three stages in
//     the cache's own dtype, completion counted in bytes on an mbarrier:
//     the block issues its first three tiles' copies at once, and tile i + 1
//     lands while tile i is computed on; elements are widened to float32 in
//     registers;
//   * slots the validity mask rejects cost nothing: a tile with no valid
//     slot is neither copied nor computed on (early in a request, or outside
//     a sliding window, most of the ring), and a masked slot inside a tile
//     gets no score and a zeroed V row, so whatever the cache holds there
//     never reaches the sums;
//   * scores are one warp per slot, four query rows at a time with their q
//     elements in registers, the four sums reduced together (6 shuffles);
//     P V gives each thread four consecutive d of one row over a run of
//     the tile's slots (16-byte loads of p, 8- or 16-byte loads of V), the
//     runs' sums added once after the last tile;
//   * the splits combine in the same launch: each writes its (m, l, acc)
//     to a float32 workspace, then takes a ticket from a per-(batch, kv
//     head, chunk) counter (__threadfence + atomicAdd); the block that
//     draws the last ticket adds all the splits in split order, so the
//     result does not depend on which block finished last and is bitwise
//     repeatable, and resets the counter to zero for the next call or
//     graph replay. The caller passes the counters: the wrapper keeps one
//     zeroed array for each stream outside a capture and one for each
//     (capture, stream), made inside the capture, so calls in flight on
//     two streams, or in two graphs, never draw each other's tickets,
//     while calls on one stream (or in one graph), which run in order,
//     find the counters their predecessor reset. No call zeroes
//     anything, so a launch stays one kernel; a graph holds one zeroing
//     of its counters before its first call on each stream.
// Later work: one launch for all the members of a decode step (a per-row
// pos); the combine's reads of the partials are latency-bound chains.
//
// Plain C interface, loaded with ctypes (see ../decode_attention.py):
//   int coserve_decode_attention(q, k, v, out, workspace, tickets, B, H,
//                                Hkv, W, D, pos, window, q_bf16, kv_bf16,
//                                tile, rows, splits, stream)
//     -> a cudaError_t; 0 means the launch was accepted. A block takes
//        `rows` query rows, so a kv head's G rows make ceil(G / rows)
//        chunks; with splits > 1 the caller passes a float32 workspace of
//        B * Hkv * chunks * splits * (rows * D + 2 * rows) and `tickets`,
//        B * Hkv * chunks <= coserve_decode_attention_max_rows() unsigned
//        counters that are zero and that no call on another stream uses.
//   int coserve_stream_capture_id(stream, unsigned long long* id)
//     -> a cudaError_t; sets *id to the id of the capture `stream` is
//        recording into, or to 0 when it records none.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;     // ring slots per tile
constexpr int kStages = 3;       // tiles in flight
constexpr int kMaxStageBytes = 32768;  // K and V of one tile
constexpr int kMaxOut = 16;      // outputs a thread: rows * D <= 4096
constexpr int kMaxQuads = kMaxOut / 4;  // four outputs a quad
constexpr int kMaxLaneD = 8;     // D / 32 elements of a K row per lane
constexpr int kMaxCombine = 16384;     // splits * rows combine weights
constexpr int kMaxRows = 1 << 16;  // B * Hkv * chunks with a ticket each
constexpr float kNegInf = -1e30f;
// the most dynamic shared memory a launch asks for: the barriers, the stages
// (or the combine's weights, which reuse them), q (rows * D <= 4096), the
// scores (rows <= 4096 / 32 of a tile), m, l, alpha and slot flags
constexpr int kMaxSmem = 128 + kStages * kMaxStageBytes + 4096 * 4 +
                         (4096 / 32) * kMaxTile * 4 + 3 * (4096 / 32) * 4 +
                         kMaxTile * 4 + 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// a[0..3] += p * v[0..3], four elements of a row in one load
__device__ __forceinline__ void fma4(float* a, float p, const float* v) {
  const float4 x = *reinterpret_cast<const float4*>(v);
  a[0] += p * x.x;
  a[1] += p * x.y;
  a[2] += p * x.z;
  a[3] += p * x.w;
}
__device__ __forceinline__ void fma4(float* a, float p,
                                     const __nv_bfloat16* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(v);
  a[0] += p * __uint_as_float(x.x << 16);
  a[1] += p * __uint_as_float(x.x & 0xffff0000u);
  a[2] += p * __uint_as_float(x.y << 16);
  a[3] += p * __uint_as_float(x.y & 0xffff0000u);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Slot `slot` holds absolute position pos - m, m = (pos - slot) mod W, so
// it is valid when m <= pos and, with a window, m < window; `pos_mod` is
// pos mod W (floor), worked out once, so that m needs no 64-bit division.
__device__ __forceinline__ bool slot_valid(long long pos, int pos_mod,
                                           int slot, int width, int window) {
  int m = pos_mod - slot;
  if (m < 0) m += width;
  return m <= pos && (window == 0 || m < window);
}

// Whether some slot of [t0, t1) is valid. The valid slots are those with
// (pos - slot) mod W below lim = min(pos + 1, window): the cyclic run
// [lo, lo + lim) mod W with lo = (pos - lim + 1) mod W. With no valid slot
// at all (pos < 0) every slot takes part, as in the TPU kernel.
__device__ __forceinline__ bool tile_has_valid(long long pos, int width,
                                               int window, int t0, int t1) {
  if (pos < 0) return true;
  long long lim = pos + 1;
  if (window && window < lim) lim = window;
  if (lim >= width) return true;
  long long lo = (pos - lim + 1) % width;
  if (lo < 0) lo += width;
  const long long hi = lo + lim;  // < 2 W
  return (t0 < hi && t1 > lo) || (t0 + width < hi && t1 + width > lo);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` contiguous bytes from global to shared memory by one bulk copy,
// counted on `bar`; both addresses and the size are multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The K and V rows of tile `tile` into stage `st`: one arrival with the
// byte count, then the two copies. Issued by one thread.
template <typename TKV>
__device__ __forceinline__ void issue_tile(const TKV* k_blk, const TKV* v_blk,
                                           TKV* k_st, TKV* v_st,
                                           uint64_t* bar, int tile_slots,
                                           int tile, int width, int D) {
  const int t0 = tile * tile_slots;
  const int tn = min(tile_slots, width - t0);
  const uint32_t bytes = (uint32_t)tn * D * sizeof(TKV);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(2 * bytes)
      : "memory");
  bulk_copy(k_st, k_blk + (size_t)t0 * D, bytes, bar);
  bulk_copy(v_st, v_blk + (size_t)t0 * D, bytes, bar);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_kernel(const TQ* __restrict__ q,
                            const TKV* __restrict__ k,
                            const TKV* __restrict__ v, TQ* __restrict__ out,
                            float* __restrict__ ws,
                            unsigned int* __restrict__ tickets, int num_heads,
                            int num_kv_heads, int width, int head_dim,
                            long long pos, int window, float scale,
                            int tile_slots, int group_rows,
                            int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kv_rows = num_heads / num_kv_heads;  // query rows of a kv head
  const int gc = blockIdx.z;                     // this block's chunk of them
  const int G = min(group_rows, kv_rows - gc * group_rows);  // its rows
  const int D = head_dim;
  const int splits = gridDim.y;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [kStages]
  unsigned char* stage0 = smem_raw + 128;
  // the stages, or after the last tile the combine's weights [G][splits]
  const int ring_bytes =
      (max(kStages * stage_bytes, (splits > 1 ? splits * G + G : 0) * 4) +
       15) & ~15;
  float* q_s = reinterpret_cast<float*>(stage0 + ring_bytes);  // [G, D]
  float* p_s = q_s + G * D;           // [G, tile] scores, then probabilities
  float* m_s = p_s + G * tile_slots;  // [G] running max
  float* l_s = m_s + G;               // [G] running sum
  float* a_s = l_s + G;               // [G] this tile's rescale factor
  int* ok_s = reinterpret_cast<int*>(a_s + G);  // [tile] slot is read
  int* last_s = ok_s + tile_slots;              // this block combines

  const int bh = blockIdx.x;  // b * Hkv + kv head
  const int bhc = bh * gridDim.z + gc;  // (batch, kv head, row chunk)
  const int split = blockIdx.y;
  const int b = bh / num_kv_heads;
  const int kvh = bh - b * num_kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = (size_t)b * num_heads + (size_t)kvh * kv_rows +
                      (size_t)gc * group_rows;
  const TQ* q_blk = q + row0 * D;
  const TKV* k_blk = k + (size_t)bh * width * D;
  const TKV* v_blk = v + (size_t)bh * width * D;
  const int n_out = G * D;
  const int nv = D / 32;
  const int n_tiles = (width + tile_slots - 1) / tile_slots;
  const bool read_all = pos < 0;
  const int pos_mod = (int)(((pos % width) + width) % width);
  auto stage_k = [&](int st) {
    return reinterpret_cast<TKV*>(stage0 + st * stage_bytes);
  };
  auto stage_v = [&](int st) {
    return reinterpret_cast<TKV*>(stage0 + st * stage_bytes +
                                  stage_bytes / 2);
  };
  // this split's tiles, in order: split, split + splits, ..., skipping the
  // tiles with no valid slot (every thread walks the same sequence)
  auto next_tile = [&](int t) {
    while (t < n_tiles &&
           !tile_has_valid(pos, width, window, t * tile_slots,
                           min(width, (t + 1) * tile_slots)))
      t += splits;
    return t;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(full + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int issued = next_tile(split);  // thread 0's cursor: the next to copy
  if (tid == 0)
    for (int s = 0; s < kStages && issued < n_tiles; ++s) {
      issue_tile(k_blk, v_blk, stage_k(s), stage_v(s), full + s, tile_slots,
                 issued, width, D);
      issued = next_tile(issued + splits);
    }

  for (int i = tid; i < n_out; i += kThreads)
    q_s[i] = to_float(q_blk[i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // P V: a thread owns four consecutive d of one row (a "quad", n_out / 4
  // of them) over one of `groups` runs of a tile's slots; the groups' sums
  // are added once, after the last tile
  const int n_quads = n_out / 4;
  const int groups = n_quads >= kThreads ? 1 : kThreads / n_quads;
  const int group = tid / n_quads;
  float acc[kMaxQuads][4];
#pragma unroll
  for (int r = 0; r < kMaxQuads; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  int j = 0;  // tiles done
  for (int tile = next_tile(split); tile < n_tiles;
       tile = next_tile(tile + splits), ++j) {
    const int st = j % kStages;
    const int t0 = tile * tile_slots;
    const int tn = min(tile_slots, width - t0);
    const bool mine =
        tid < tn &&
        (read_all || slot_valid(pos, pos_mod, t0 + tid, width, window));
    if (tid < tile_slots) ok_s[tid] = mine;
    const TKV* k_s = stage_k(st);
    TKV* v_s = stage_v(st);
    mbar_wait(full + st, (j / kStages) & 1);
    // a masked slot's V row is zeroed, so that whatever the cache holds
    // there meets only zero weights
    if (__syncthreads_count(mine) < tn)
      for (int i = tid; i < tn * D; i += kThreads)
        if (!ok_s[i / D]) v_s[i] = from_float<TKV>(0.f);
    __syncthreads();

    // scores: one warp per slot, the lanes split D; four query rows at a
    // time, their q elements held in registers across the warp's slots,
    // the four sums reduced together (reduce-scatter: 6 shuffles). With
    // no valid slot at all (pos < 0) every score is -1e30, as in the
    // reference, so the row averages v.
    for (int g0 = 0; g0 < G; g0 += 4) {
      float qr[4][kMaxLaneD];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int jj = 0; jj < kMaxLaneD; ++jj)
          qr[u][jj] = g0 + u < G && jj < nv
                          ? q_s[(g0 + u) * D + lane + 32 * jj]
                          : 0.f;
      for (int t = warp; t < tn; t += kWarps) {
        float sum;
        if (!ok_s[t] || read_all) {
          sum = kNegInf;
        } else {
          const TKV* krow = k_s + t * D;
          float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int jj = 0; jj < kMaxLaneD; ++jj) {
            if (jj < nv) {
              const float kv = to_float(krow[lane + 32 * jj]);
#pragma unroll
              for (int u = 0; u < 4; ++u) s[u] += qr[u][jj] * kv;
            }
          }
          // lanes 0-15 keep rows 0, 1 and lanes 16-31 rows 2, 3; then
          // lanes with bit 3 clear keep the first of those two
          const bool h16 = lane & 16, h8 = lane & 8;
          float a0 = h16 ? s[2] : s[0], a1 = h16 ? s[3] : s[1];
          a0 += __shfl_xor_sync(0xffffffffu, h16 ? s[0] : s[2], 16);
          a1 += __shfl_xor_sync(0xffffffffu, h16 ? s[1] : s[3], 16);
          sum = h8 ? a1 : a0;
          sum += __shfl_xor_sync(0xffffffffu, h8 ? a0 : a1, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        }
        // lanes 8 u hold row g0 + u
        if ((lane & 7) == 0 && g0 + (lane >> 3) < G)
          p_s[(g0 + (lane >> 3)) * tile_slots + t] = sum;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * tile_slots;
      float mx = kNegInf;
      for (int t = lane; t < tn; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < tn; t += 32) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d..d+3] = acc * alpha[g] + sum_t p[g, t] * v[t, d..d+3] over
    // this thread's run of slots, four slots a step (p as one 16-byte load)
    if (group < groups) {
      const int run = ((tn + groups - 1) / groups + 3) & ~3;
      const int t_lo = group * run, t_hi = min(tn, t_lo + run);
#pragma unroll
      for (int r = 0; r < kMaxQuads; ++r) {
        const int quad = tid % n_quads + r * kThreads;
        if (quad < n_quads && (r == 0 || groups == 1)) {
          const int g = quad * 4 / D;
          const int d = quad * 4 - g * D;
          const float alpha = a_s[g];
          float* a = acc[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] *= alpha;
          const float* prow = p_s + g * tile_slots;
          const TKV* vcol = v_s + d;
          int t = t_lo;
          for (; t + 4 <= t_hi; t += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(prow + t);
            fma4(a, p4.x, vcol + t * D);
            fma4(a, p4.y, vcol + (t + 1) * D);
            fma4(a, p4.z, vcol + (t + 2) * D);
            fma4(a, p4.w, vcol + (t + 3) * D);
          }
          for (; t < t_hi; ++t) fma4(a, prow[t], vcol + t * D);
        }
      }
    }
    // every thread is done with stage st; its loads (and stores) of the
    // stage are ordered before the next copy into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && issued < n_tiles) {
      issue_tile(k_blk, v_blk, stage_k(st), stage_v(st), full + st,
                 tile_slots, issued, width, D);
      issued = next_tile(issued + splits);
    }
  }

  // the groups' sums, added in group order through shared memory (the
  // stages are free now): fin[r] is output tid + r * kThreads
  float* red_s = reinterpret_cast<float*>(stage0);  // [groups][G * D]
  if (group < groups) {
#pragma unroll
    for (int r = 0; r < kMaxQuads; ++r) {
      const int quad = tid % n_quads + r * kThreads;
      if (quad < n_quads && (r == 0 || groups == 1))
        *reinterpret_cast<float4*>(red_s + group * n_out + quad * 4) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();
  float fin[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int o = tid + r * kThreads;
    fin[r] = 0.f;
    if (o < n_out)
      for (int gr = 0; gr < groups; ++gr) fin[r] += red_s[gr * n_out + o];
  }
  __syncthreads();  // red_s is read before the combine reuses it

  if (splits == 1) {
    TQ* o_blk = out + row0 * D;
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int o = tid + r * kThreads;
      if (o < n_out)
        o_blk[o] = from_float<TQ>(fin[r] / fmaxf(l_s[o / D], 1e-30f));
    }
    return;
  }
  // partial of this split: acc [G, D], then m [G], then l [G], each part
  // sized for group_rows rows
  const int m_off = group_rows * D, l_off = m_off + group_rows;
  const size_t stride = (size_t)l_off + group_rows;
  float* parts = ws + (size_t)bhc * splits * stride;
  float* part = parts + split * stride;
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int o = tid + r * kThreads;
    if (o < n_out) part[o] = fin[r];
  }
  for (int g = tid; g < G; g += kThreads) {
    part[m_off + g] = m_s[g];
    part[l_off + g] = l_s[g];
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0)
    *last_s = atomicAdd(&tickets[bhc], 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();

  // the last split combines all of them, in split order:
  // out[g, d] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s
  float* w_s = reinterpret_cast<float*>(stage0);  // [G][splits]
  float* den_s = w_s + G * splits;                // [G]
  for (int g = warp; g < G; g += kWarps) {
    float m = kNegInf;
    for (int s = lane; s < splits; s += 32)
      m = fmaxf(m, __ldcg(parts + s * stride + m_off + g));
    m = warp_max(m);
    float den = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float w = expf(__ldcg(parts + s * stride + m_off + g) - m);
      w_s[g * splits + s] = w;
      den += w * __ldcg(parts + s * stride + l_off + g);
    }
    // the lanes' partial sums in a fixed order, as every call adds them
    den = warp_sum(den);
    if (lane == 0) den_s[g] = den;
  }
  __syncthreads();
  // four outputs of the thread at a time, so that many loads of the
  // partials are in flight together (an output past n_out reads a valid
  // address and is not stored); each output adds the splits in split order
  TQ* o_blk = out + row0 * D;
  for (int o0 = tid; o0 < n_out; o0 += 4 * kThreads) {
    int oc[4];
    const float* w[4];
    float num[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      oc[i] = min(o0 + i * kThreads, n_out - 1);
      w[i] = w_s + (oc[i] / D) * splits;
      num[i] = 0.f;
    }
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float* part_s = parts + s * stride;
#pragma unroll
      for (int i = 0; i < 4; ++i) num[i] += w[i][s] * __ldcg(part_s + oc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (o0 + i * kThreads < n_out)
        o_blk[oc[i]] =
            from_float<TQ>(num[i] / fmaxf(den_s[oc[i] / D], 1e-30f));
  }
  if (tid == 0) tickets[bhc] = 0;  // ready for the stream's next call
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* ws, unsigned int* tickets, int batch,
                   int num_heads, int num_kv_heads, int width,
                   int head_dim, long long pos, int window,
                   int tile_slots, int group_rows, int splits,
                   cudaStream_t stream) {
  const int G = group_rows;  // the most rows a block takes
  const int chunks = (num_heads / num_kv_heads + G - 1) / G;
  const int stage_bytes = 2 * tile_slots * head_dim * (int)sizeof(TKV);
  if (stage_bytes > kMaxStageBytes) return cudaErrorInvalidValue;
  const size_t ring_bytes =
      (std::max((size_t)kStages * stage_bytes,
                (size_t)(splits > 1 ? splits * G + G : 0) * 4) +
       15) & ~(size_t)15;
  const size_t smem =
      128 + ring_bytes +
      sizeof(float) * ((size_t)G * head_dim + (size_t)G * tile_slots +
                       3 * (size_t)G) +
      sizeof(int) * (tile_slots + 1);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = decode_attention_kernel<TQ, TKV>;
  // once per instantiation (thread-safe static init), so that a launch does
  // nothing but launch: it can then be captured in a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const float scale = (float)(1.0 / std::sqrt((double)head_dim));
  kernel<<<dim3(batch * num_kv_heads, splits, chunks), kThreads, smem,
           stream>>>(static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                     static_cast<const TKV*>(v), static_cast<TQ*>(out),
                     static_cast<float*>(ws), tickets, num_heads,
                     num_kv_heads, width, head_dim, pos, window, scale,
                     tile_slots, group_rows, stage_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int coserve_decode_attention(const void* q, const void* k,
                                        const void* v, void* out, void* ws,
                                        void* tickets, int batch,
                                        int num_heads, int num_kv_heads,
                                        int width,
                                        int head_dim, long long pos,
                                        int window, int q_bf16, int kv_bf16,
                                        int tile_slots, int group_rows,
                                        int splits, void* stream) {
  const int G = num_kv_heads > 0 ? num_heads / num_kv_heads : 0;
  const int chunks = group_rows > 0 ? (G + group_rows - 1) / group_rows : 0;
  if (batch <= 0 || num_kv_heads <= 0 || num_heads <= 0 ||
      num_heads % num_kv_heads != 0 || head_dim <= 0 || head_dim % 32 != 0 ||
      head_dim > 32 * kMaxLaneD || width <= 0 || window < 0 ||
      group_rows < 1 || group_rows > G ||
      group_rows * head_dim > kThreads * kMaxOut || tile_slots < 16 ||
      tile_slots > kMaxTile || tile_slots % 16 != 0 || splits < 1 ||
      splits > (width + tile_slots - 1) / tile_slots || chunks > 65535 ||
      (splits > 1 &&
       (ws == nullptr || tickets == nullptr ||
        splits * group_rows > kMaxCombine ||
        (long long)batch * num_kv_heads * chunks > kMaxRows)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  if (!q_bf16 && !kv_bf16)
    return (int)launch<float, float>(q, k, v, out, ws, t, batch, num_heads,
                                     num_kv_heads, width, head_dim, pos,
                                     window, tile_slots, group_rows, splits,
                                     s);
  if (q_bf16 && kv_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, out, ws, t, batch, num_heads, num_kv_heads, width, head_dim,
        pos, window, tile_slots, group_rows, splits, s);
  if (!q_bf16 && kv_bf16)
    return (int)launch<float, __nv_bfloat16>(
        q, k, v, out, ws, t, batch, num_heads, num_kv_heads, width, head_dim,
        pos, window, tile_slots, group_rows, splits, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int coserve_stream_capture_id(void* stream,
                                         unsigned long long* id) {
  cudaStreamCaptureStatus status;
  unsigned long long capture = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &capture);
  if (err != cudaSuccess) return (int)err;
  *id = status == cudaStreamCaptureStatusActive ? capture : 0;
  return 0;
}

// the most (batch, kv head, row chunk) tickets a call with splits > 1 uses
extern "C" int coserve_decode_attention_max_rows() { return kMaxRows; }

extern "C" const char* coserve_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
