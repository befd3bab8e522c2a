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
// What the design does about that:
//   * a block works for one (batch, kv head): the G query rows of the head
//     share every K and V row it reads, so each element crosses device
//     memory once;
//   * the ring's tiles are dealt out round-robin to `splits` blocks per
//     (batch, kv head), enough to fill the card's SMs even at B = 1; each
//     writes its partial (m, l, acc) to a float32 workspace and a second
//     kernel, one block per query row, combines them (with one split, the
//     first writes the output);
//   * slots the validity mask rejects are not read: a tile with no valid slot
//     is skipped whole (early in a request, or outside a sliding window, most
//     of the ring), and a masked slot inside a tile loads no K and a zero V row;
//   * a tile of K and V rows is one contiguous run of memory: every thread
//     issues its 16-byte loads of both before it waits on any, and the tile
//     lands in shared memory as float32; scores are then one warp per slot
//     (four query rows' reductions interleaved), and each thread owns
//     (row, d) outputs whose accumulators stay in registers.
// Later work: a second tile in flight while one is computed on, and one
// launch for all the members of a decode step.
//
// Plain C interface, loaded with ctypes (see ../decode_attention.py):
//   int coserve_decode_attention_splits(B, Hkv, W, sm_count)
//     -> blocks per (batch, kv head); the caller allocates a float32
//        workspace of B * Hkv * splits * (G * D + 2 * G) when splits > 1
//   int coserve_decode_attention(q, k, v, out, workspace, B, H, Hkv, W, D,
//                                pos, window, q_bf16, kv_bf16, splits, stream)
//     -> a cudaError_t; 0 means the launches were accepted.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // ring slots per tile
constexpr int kMaxOut = 16;   // accumulators per thread, so G * D <= 4096
constexpr int kMaxLaneD = 8;  // D / 32 elements of a K row per lane, D <= 256
constexpr int kLoads = 4;     // 16-byte loads of K and of V in flight a thread
constexpr int kMaxSplits = 2048;  // blocks per (batch, kv head)
constexpr float kNegInf = -1e30f;
// the most dynamic shared memory a launch asks for: q (G*D <= 4096), the K
// and V tiles (D <= 256), the scores (G <= 4096 / 32), m, l, alpha, slot flags
constexpr int kMaxSmem = (4096 + 2 * kTile * 256 + (4096 / 32) * kTile +
                          3 * (4096 / 32)) * 4 + kTile * 4;

// 16 bytes of TKV as float32: 4 floats, or 8 from bfloat16 (the high half of
// a float's bits, low element first)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    *reinterpret_cast<float4*>(f) = make_float4(
        __uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
        __uint_as_float(u.w));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    reinterpret_cast<float4*>(f)[0] = make_float4(
        __uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
        __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
    reinterpret_cast<float4*>(f)[1] = make_float4(
        __uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
        __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
  }
};

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Slot `slot` holds absolute position pos - ((pos - slot) mod W); C's % truncates,
// so the remainder is brought back to [0, W) by hand.
__device__ __forceinline__ bool slot_valid(long long pos, int slot, int width,
                                           int window) {
  long long m = (pos - slot) % width;
  if (m < 0) m += width;
  const long long abs_pos = pos - m;
  return abs_pos >= 0 && (window == 0 || pos - abs_pos < window);
}

// Rows [t0, t0 + tn) of K and V into shared memory as float32, masked rows
// as zeros. The rows are contiguous, so the tile is tn * D / Vec::n 16-byte
// vectors; each thread issues kLoads of K and kLoads of V before it unpacks.
template <typename TKV>
__device__ __forceinline__ void load_tiles(const TKV* k_rows,
                                           const TKV* v_rows, float* k_s,
                                           float* v_s, const int* ok_s,
                                           int tn, int D, int tid) {
  constexpr int V = Vec<TKV>::n;
  const int n_vec = tn * D / V;
  const uint4* k4 = reinterpret_cast<const uint4*>(k_rows);
  const uint4* v4 = reinterpret_cast<const uint4*>(v_rows);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int base = 0; base < n_vec; base += kThreads * kLoads) {
    uint4 kb[kLoads], vb[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int c = base + u * kThreads + tid;
      const bool use = c < n_vec && ok_s[c * V / D];
      kb[u] = use ? __ldg(k4 + c) : zero;
      vb[u] = use ? __ldg(v4 + c) : zero;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int c = base + u * kThreads + tid;
      if (c < n_vec) {
        Vec<TKV>::unpack(kb[u], k_s + c * V);
        Vec<TKV>::unpack(vb[u], v_s + c * V);
      }
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const TQ* __restrict__ q,
                            const TKV* __restrict__ k,
                            const TKV* __restrict__ v, TQ* __restrict__ out,
                            float* __restrict__ ws, int num_heads,
                            int num_kv_heads, int width, int head_dim,
                            long long pos, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = num_heads / num_kv_heads;
  const int D = head_dim;
  float* q_s = smem;             // [G, D] query rows, pre-scaled
  float* k_s = q_s + G * D;      // [kTile, D] this tile's K rows
  float* v_s = k_s + kTile * D;  // [kTile, D] this tile's V rows
  float* p_s = v_s + kTile * D;  // [G, kTile] scores, then probabilities
  float* m_s = p_s + G * kTile;  // [G] running max
  float* l_s = m_s + G;          // [G] running sum
  float* a_s = l_s + G;          // [G] this tile's rescale factor
  int* ok_s = reinterpret_cast<int*>(a_s + G);  // [kTile] slot is read

  const int bh = blockIdx.x;  // b * Hkv + kv head
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = bh / num_kv_heads;
  const int kvh = bh - b * num_kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = (size_t)b * num_heads + (size_t)kvh * G;
  const TQ* q_blk = q + row0 * D;
  const TKV* k_blk = k + (size_t)bh * width * D;
  const TKV* v_blk = v + (size_t)bh * width * D;
  const int n_out = G * D;
  const int nv = D / 32;
  const int n_tiles = (width + kTile - 1) / kTile;
  // with no valid slot at all (pos < 0) every slot takes part, as in the TPU
  // kernel, and the row averages v
  const bool read_all = pos < 0;

  for (int i = tid; i < n_out; i += kThreads)
    q_s[i] = to_float(q_blk[i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int tile = split; tile < n_tiles; tile += splits) {
    const int t0 = tile * kTile;
    const int tn = min(kTile, width - t0);
    const bool mine =
        tid < tn && (read_all || slot_valid(pos, t0 + tid, width, window));
    if (tid < kTile) ok_s[tid] = mine;
    if (!__syncthreads_or(mine)) continue;  // nothing to read in this tile

    // a masked row is zero: its weight is zero, or is wiped by a later
    // rescale, so it only has to be finite
    load_tiles(k_blk + (size_t)t0 * D, v_blk + (size_t)t0 * D, k_s, v_s,
               ok_s, tn, D, tid);
    __syncthreads();

    // scores: one warp per slot, the lanes split D, four query rows'
    // reductions interleaved
    for (int t = warp; t < tn; t += kWarps) {
      float* col = p_s + t;
      if (!ok_s[t]) {
        for (int g = lane; g < G; g += 32) col[g * kTile] = kNegInf;
        continue;
      }
      const float* krow = k_s + t * D;
      float kr[kMaxLaneD];
#pragma unroll
      for (int j = 0; j < kMaxLaneD; ++j)
        kr[j] = j < nv ? krow[lane + 32 * j] : 0.f;
      for (int g0 = 0; g0 < G; g0 += 4) {
        float s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[u] = 0.f;
          if (g0 + u < G) {
            const float* qr = q_s + (g0 + u) * D;
#pragma unroll
            for (int j = 0; j < kMaxLaneD; ++j)
              if (j < nv) s[u] += qr[lane + 32 * j] * kr[j];
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
        }
        if (lane < 4 && g0 + lane < G) {
          float mine_s = s[0];
#pragma unroll
          for (int u = 1; u < 4; ++u)
            if (lane == u) mine_s = s[u];
          col[(g0 + lane) * kTile] = mine_s;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kTile;
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

    // acc[g, d] = acc * alpha[g] + sum_t p[g, t] * v[t, d], four partial
    // sums in flight
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int o = tid + r * kThreads;
      if (o < n_out) {
        const int g = o / D;
        const int d = o - g * D;
        const float* prow = p_s + g * kTile;
        const float* vcol = v_s + d;
        float a0 = acc[r] * a_s[g], a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int t = 0;
        for (; t + 4 <= tn; t += 4) {
          a0 += prow[t] * vcol[t * D];
          a1 += prow[t + 1] * vcol[(t + 1) * D];
          a2 += prow[t + 2] * vcol[(t + 2) * D];
          a3 += prow[t + 3] * vcol[(t + 3) * D];
        }
        for (; t < tn; ++t) a0 += prow[t] * vcol[t * D];
        acc[r] = (a0 + a1) + (a2 + a3);
      }
    }
    __syncthreads();
  }

  if (splits == 1) {
    TQ* o_blk = out + row0 * D;
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int o = tid + r * kThreads;
      if (o < n_out)
        o_blk[o] = from_float<TQ>(acc[r] / fmaxf(l_s[o / D], 1e-30f));
    }
    return;
  }
  // partial of this split: acc [G, D], then m [G], then l [G]
  float* part = ws + ((size_t)bh * splits + split) * (n_out + 2 * G);
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int o = tid + r * kThreads;
    if (o < n_out) part[o] = acc[r];
  }
  for (int g = tid; g < G; g += kThreads) {
    part[n_out + g] = m_s[g];
    part[n_out + G + g] = l_s[g];
  }
}

// out[g, d] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s:
// the online softmax's own rescale, applied across the splits. One block per
// (batch, kv head, query row): the split weights are worked out once in
// shared memory, then each thread sums its d over the splits, sixteen
// independent loads in flight.
__device__ __forceinline__ float block_reduce(float x, float* red, bool max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = max ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < kWarps ? red[lane] : (max ? kNegInf : 0.f);
  return max ? warp_max(x) : warp_sum(x);
}

template <typename TQ>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ ws, TQ* __restrict__ out,
                   int num_heads, int num_kv_heads, int head_dim,
                   int splits) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float red[kWarps];
  const int G = num_heads / num_kv_heads;
  const int D = head_dim;
  const int n_out = G * D;
  const size_t stride = (size_t)n_out + 2 * G;
  const int bh = blockIdx.x;
  const int g = blockIdx.y;
  const int b = bh / num_kv_heads;
  const int kvh = bh - b * num_kv_heads;
  const int tid = threadIdx.x;
  const float* parts = ws + (size_t)bh * splits * stride;

  float m = kNegInf;
  for (int s = tid; s < splits; s += kThreads) {
    w_s[s] = parts[s * stride + n_out + g];
    m = fmaxf(m, w_s[s]);
  }
  m = block_reduce(m, red, true);
  float den = 0.f;
  for (int s = tid; s < splits; s += kThreads) {
    const float w = expf(w_s[s] - m);
    w_s[s] = w;
    den += w * parts[s * stride + n_out + G + g];
  }
  den = block_reduce(den, red, false);  // its barriers publish w_s too

  TQ* o_row = out + ((size_t)b * num_heads + (size_t)kvh * G + g) * D;
  for (int d = tid; d < D; d += kThreads) {
    const float* col = parts + (size_t)g * D + d;
    float num = 0.f;
#pragma unroll 16
    for (int s = 0; s < splits; ++s) num += w_s[s] * col[s * stride];
    o_row[d] = from_float<TQ>(num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* ws, int batch, int num_heads, int num_kv_heads,
                   int width, int head_dim, long long pos, int window,
                   int splits, cudaStream_t stream) {
  const int G = num_heads / num_kv_heads;
  const size_t smem =
      sizeof(float) * ((size_t)G * head_dim + 2 * (size_t)kTile * head_dim +
                       (size_t)G * kTile + 3 * (size_t)G) +
      sizeof(int) * kTile;
  auto kernel = decode_attention_kernel<TQ, TKV>;
  // once per instantiation (thread-safe static init), so that a launch does
  // nothing but launch: it can then be captured in a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  cudaError_t err;
  const float scale = (float)(1.0 / std::sqrt((double)head_dim));
  kernel<<<dim3(batch * num_kv_heads, splits), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(out),
      static_cast<float*>(ws), num_heads, num_kv_heads, width, head_dim, pos,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  combine_kernel<TQ><<<dim3(batch * num_kv_heads, G), kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<TQ*>(out), num_heads,
      num_kv_heads, head_dim, splits);
  return cudaGetLastError();
}

}  // namespace

// Blocks per (batch, kv head): about four blocks per SM over the whole grid
// (a block's tile is latency-bound, so several share an SM), never more than
// the ring has tiles or the combine kernel takes.
extern "C" int coserve_decode_attention_splits(int batch, int num_kv_heads,
                                               int width, int sm_count) {
  const int n_tiles = (width + kTile - 1) / kTile;
  const int rows = batch * num_kv_heads;
  int splits = (4 * sm_count + rows - 1) / rows;
  if (splits > n_tiles) splits = n_tiles;
  if (splits > kMaxSplits) splits = kMaxSplits;
  return splits < 1 ? 1 : splits;
}

extern "C" int coserve_decode_attention(const void* q, const void* k,
                                        const void* v, void* out, void* ws,
                                        int batch, int num_heads,
                                        int num_kv_heads, int width,
                                        int head_dim, long long pos,
                                        int window, int q_bf16, int kv_bf16,
                                        int splits, void* stream) {
  if (batch <= 0 || num_kv_heads <= 0 || num_heads <= 0 ||
      num_heads % num_kv_heads != 0 || head_dim <= 0 || head_dim % 32 != 0 ||
      head_dim > 32 * kMaxLaneD || width <= 0 || window < 0 ||
      (num_heads / num_kv_heads) * head_dim > kThreads * kMaxOut ||
      splits < 1 || splits > (width + kTile - 1) / kTile ||
      splits > kMaxSplits || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!q_bf16 && !kv_bf16)
    return (int)launch<float, float>(q, k, v, out, ws, batch, num_heads,
                                     num_kv_heads, width, head_dim, pos,
                                     window, splits, s);
  if (q_bf16 && kv_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, out, ws, batch, num_heads, num_kv_heads, width, head_dim,
        pos, window, splits, s);
  if (!q_bf16 && kv_bf16)
    return (int)launch<float, __nv_bfloat16>(
        q, k, v, out, ws, batch, num_heads, num_kv_heads, width, head_dim,
        pos, window, splits, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* coserve_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
