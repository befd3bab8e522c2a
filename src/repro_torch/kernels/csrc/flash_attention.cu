// Forward (prefill) attention with GQA, right-aligned causality and an
// optional sliding window, written by hand for Hopper (sm_90a). It replaces
// the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _fa_kernel) and computes what that kernel computes: for q [B,H,S,D]
// and k, v [B,Hkv,T,D] with T >= S, query head h attends to kv head
// h / (H / Hkv); query row i sits at position T - S + i; keys past T, keys
// after the row (causal) and keys at or beyond `window` positions back are
// masked with -1e30 (not -inf); the softmax runs online in float32 and the
// output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: operations. At a prefill shape (S = T = 4096, D = 128)
// every K and V element read feeds 4 * 64 query rows' FMAs per block, far
// above the card's ~295 bf16 operations per byte of device memory, so the
// tensor cores are the limit (4 * B * H * D operations per unmasked q-k pair).
// What the design does about that:
//   * one block per (64-row q tile, batch, query head); a loop over 64-key
//     tiles inside the block takes the place of the Pallas sequential kv
//     grid axis, bounded by the causal and window limits of the block's
//     first and last row, so tiles wholly above the diagonal or outside the
//     window are never loaded; the q tiles run latest first, so the blocks
//     with the most tiles start first;
//   * bf16: four warps, sixteen q rows each; S = Q K^T and O += P V run on
//     the tensor cores as mma.sync m16n8k16 with float32 accumulators; the
//     Q fragments, the scores and the output accumulator stay in registers
//     (the scores' accumulator layout is the A-operand layout of P V, so P
//     never goes through shared memory); V's B fragments come from shared
//     memory by ldmatrix.trans; K and V tiles arrive by cp.async, K of the
//     next tile while this tile's softmax and P V run, V of a tile while its
//     scores are computed; rows are padded by 16 bytes so that fragment
//     loads hit 32 distinct banks;
//   * float32: plain FMA on the CUDA cores (no TF32, so float32 stays exact
//     to ~1e-6), register tiles of 2 x 4 scores and 4 x D/16 outputs a
//     thread, tiles of 32 keys through shared memory;
//   * the ragged edges are masked in the kernel: q rows past S are neither
//     loaded nor stored and keys past T are zero rows with -1e30 scores, so
//     the wrapper pads nothing; q, k, v and out are read and written through
//     their strides (the last dimension contiguous), so the transposed views
//     the transformer hands over need no copy.
// Later work: wgmma with TMA and a producer warp, so that loads and both
// products overlap across warpgroups.
//
// Plain C interface, loaded with ctypes (see ../flash_attention.py):
//   int coserve_flash_attention(q, k, v, out, B, H, Hkv, S, T, D,
//                               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
//                               v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
//                               causal, window, bf16, stream)
//     strides in elements; D one of 32, 64, 96, 128; returns a cudaError_t,
//     0 when the launch was accepted.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;  // query rows per block (both kernels)

struct Params {
  int S, T, group;  // group = H / Hkv
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;
  float scale;
};

// The keys [lo, hi) any row of the q tile [q0, q1) may see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int q1,
                                          int& lo, int& hi) {
  const int off = p.T - p.S;
  hi = p.causal ? min(p.T, q1 - 1 + off + 1) : p.T;
  lo = p.window ? max(0, q0 + off - p.window + 1) : 0;
}

// Whether some (row, key) of the q tile [q0, q1) and the key tile
// [k0, k0 + n) is masked: only such tiles pay for the per-element mask.
__device__ __forceinline__ bool tile_has_mask(const Params& p, int q0, int q1,
                                              int k0, int n) {
  const int off = p.T - p.S;
  return k0 + n > p.T || (p.causal && k0 + n - 1 > q0 + off) ||
         (p.window && q1 - 1 + off - k0 >= p.window);
}

__device__ __forceinline__ bool key_visible(const Params& p, int qpos,
                                            int kpos) {
  return kpos < p.T && !(p.causal && kpos > qpos) &&
         !(p.window && qpos - kpos >= p.window);
}

// ------------------------------------------------------------------------ //
// bf16: tensor cores
// ------------------------------------------------------------------------ //

constexpr int kThreadsBf16 = 128;  // four warps of sixteen q rows
constexpr int kBlockK = 64;        // keys per tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a strided [rows, D] matrix into a shared tile of
// row stride D + 8, rows at or past row_end zero-filled, by cp.async.
template <int D>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int row0,
                                           int row_end, int tid) {
  constexpr int kVec = D / 8;  // 16-byte vectors a row
#pragma unroll
  for (int i = 0; i < kBlockK * kVec / kThreadsBf16; ++i) {
    const int c = i * kThreadsBf16 + tid;
    const int r = c / kVec, j = c - r * kVec;
    const bool ok = row0 + r < row_end;
    const __nv_bfloat16* g =
        ok ? src + (long long)(row0 + r) * row_stride + j * 8 : src;
    cp_async16(dst + r * (D + 8) + j * 8, g, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, Params p) {
  constexpr int kStride = D + 8;  // bf16 elements a shared row
  constexpr int kSteps = D / 16;  // k-steps of Q K^T
  constexpr int kDTiles = D / 8;  // n8 tiles of the output
  constexpr int kNTiles = kBlockK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kBlockK * kStride;

  const int qt = gridDim.x - 1 - blockIdx.x;  // latest (longest) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBlockQ, q1 = min(q0 + kBlockQ, p.S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const __nv_bfloat16* q_blk = q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k_blk = k + b * p.k_sb + (h / p.group) * p.k_sh;
  const __nv_bfloat16* v_blk = v + b * p.v_sb + (h / p.group) * p.v_sh;

  // the Q tile passes through k_s into this warp's A fragments
  tile_async<D>(k_s, q_blk, p.q_ss, q0, q1, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const __nv_bfloat16* a = k_s + r0 * kStride + ks * 16 + tg * 2;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(a);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(a + 8 * kStride);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(a + 8);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(a + 8 * kStride + 8);
  }
  __syncthreads();

  int lo, hi;
  key_range(p, q0, q1, lo, hi);
  const int first = lo / kBlockK * kBlockK;
  if (first < hi) {
    tile_async<D>(k_s, k_blk, p.k_ss, first, p.T, tid);
    cp_async_commit();
    tile_async<D>(v_s, v_blk, p.v_ss, first, p.T, tid);
    cp_async_commit();
  }

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int qpos0 = q0 + r0 + p.T - p.S, qpos1 = qpos0 + 8;

  for (int k0 = first; k0 < hi; k0 += kBlockK) {
    const bool more = k0 + kBlockK < hi;
    cp_async_wait<1>();  // this tile's K (its V may still be in flight)
    __syncthreads();

    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const __nv_bfloat16* kr = k_s + (nt * 8 + g) * kStride + ks * 16 +
                                  tg * 2;
        mma_bf16(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    __syncthreads();  // every warp is done with k_s
    if (more) tile_async<D>(k_s, k_blk, p.k_ss, k0 + kBlockK, p.T, tid);
    cp_async_commit();  // possibly empty: keeps the group count uniform

    const bool masked = tile_has_mask(p, q0, q1, k0, kBlockK);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (masked && !key_visible(p, e < 2 ? qpos0 : qpos1,
                                   k0 + nt * 8 + tg * 2 + (e & 1)))
          x = kNegInf;
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // a row's 64 scores lie in the four lanes of its quad
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - n0), alpha1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = expf(s[nt][0] - n0);
      s[nt][1] = expf(s[nt][1] - n0);
      s[nt][2] = expf(s[nt][2] - n1);
      s[nt][3] = expf(s[nt][3] - n1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o_);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o_);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }

    cp_async_wait<1>();  // this tile's V (the next K may still be in flight)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      // the accumulators of score tiles 2kk and 2kk+1 are P's A fragment
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = v_s + (kk * 16 + (lane & 15)) * kStride;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vr + dt * 8);
        mma_bf16(o[dt], a, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with v_s
    if (more) tile_async<D>(v_s, v_blk, p.v_ss, k0 + kBlockK, p.T, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* o_blk = out + b * p.o_sb + h * p.o_sh;
  const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int d = dt * 8 + tg * 2;
    if (row0 < q1)
      *reinterpret_cast<__nv_bfloat162*>(o_blk + row0 * p.o_ss + d) =
          __floats2bfloat162_rn(o[dt][0] * inv0, o[dt][1] * inv0);
    if (row1 < q1)
      *reinterpret_cast<__nv_bfloat162*>(o_blk + row1 * p.o_ss + d) =
          __floats2bfloat162_rn(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

// ------------------------------------------------------------------------ //
// float32: CUDA cores
// ------------------------------------------------------------------------ //

constexpr int kThreadsF32 = 256;
constexpr int kBlockKF32 = 32;  // keys per tile

template <int D>
constexpr size_t f32_smem_bytes() {
  // q [64][D+1], k [32][D+1], v [32][D], p [64][33], m, l, alpha [64]
  return sizeof(float) * ((size_t)kBlockQ * (D + 1) +
                          (size_t)kBlockKF32 * (D + 1) +
                          (size_t)kBlockKF32 * D +
                          (size_t)kBlockQ * (kBlockKF32 + 1) + 3 * kBlockQ);
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     Params p) {
  constexpr int kQS = D + 1;             // padded row of q and k
  constexpr int kPS = kBlockKF32 + 1;    // padded row of p
  constexpr int kOut = D / 16;           // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * kQS;
  float* v_s = k_s + kBlockKF32 * kQS;
  float* p_s = v_s + kBlockKF32 * D;
  float* m_s = p_s + kBlockQ * kPS;
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBlockQ, q1 = min(q0 + kBlockQ, p.S);
  const int tid = threadIdx.x;
  const float* q_blk = q + b * p.q_sb + h * p.q_sh;
  const float* k_blk = k + b * p.k_sb + (h / p.group) * p.k_sh;
  const float* v_blk = v + b * p.v_sb + (h / p.group) * p.v_sh;
  const int off = p.T - p.S;

  for (int i = tid; i < kBlockQ * D; i += kThreadsF32) {
    const int r = i / D, d = i - r * D;
    q_s[r * kQS + d] =
        q0 + r < q1 ? q_blk[(long long)(q0 + r) * p.q_ss + d] * p.scale : 0.f;
  }
  for (int r = tid; r < kBlockQ; r += kThreadsF32) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  // scores: rows sr, sr + 1 and keys sc .. sc + 3 of the tile
  const int sr = (tid / 8) * 2, sc = (tid % 8) * 4;
  // softmax: four threads a row, eight keys each
  const int xr = tid / 4, xc = (tid % 4) * 8;
  // output: rows orow .. orow + 3, columns tid % 16 + 16 j
  const int orow = (tid / 16) * 4, ocol = tid % 16;
  float acc[4][kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;

  int lo, hi;
  key_range(p, q0, q1, lo, hi);
  for (int k0 = lo / kBlockKF32 * kBlockKF32; k0 < hi; k0 += kBlockKF32) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockKF32 * D; i += kThreadsF32) {
      const int r = i / D, d = i - r * D;
      const bool ok = k0 + r < p.T;
      k_s[r * kQS + d] = ok ? k_blk[(long long)(k0 + r) * p.k_ss + d] : 0.f;
      v_s[r * D + d] = ok ? v_blk[(long long)(k0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a0 = q_s[sr * kQS + d], a1 = q_s[(sr + 1) * kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = k_s[(sc + j) * kQS + d];
        s[0][j] += a0 * kv;
        s[1][j] += a1 * kv;
      }
    }
    const bool masked = tile_has_mask(p, q0, q1, k0, kBlockKF32);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(sr + i) * kPS + sc + j] =
            masked && !key_visible(p, q0 + sr + i + off, k0 + sc + j)
                ? kNegInf
                : s[i][j];
    __syncthreads();

    {
      float* row = p_s + xr * kPS + xc;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[xr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float e = expf(row[c] - m_new);
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the quad has read m_s[xr]
      if ((tid & 3) == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[xr] = alpha;
        l_s[xr] = l_s[xr] * alpha + sum;
        m_s[xr] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[orow + i];
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBlockKF32; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(orow + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float x = v_s[c * D + ocol + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * x;
      }
    }
  }
  __syncthreads();

  float* o_blk = out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + orow + i;
    if (row >= q1) continue;
    const float inv = 1.f / fmaxf(l_s[orow + i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      o_blk[row * p.o_ss + ocol + 16 * j] = acc[i][j] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Params& p, int batch, int heads, int bf16,
                   cudaStream_t stream) {
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, heads, batch);
  if (bf16) {
    const size_t smem = sizeof(__nv_bfloat16) * 2 * kBlockK * (D + 8);
    flash_bf16_kernel<D><<<grid, kThreadsBf16, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), p);
    return cudaGetLastError();
  }
  constexpr size_t smem = f32_smem_bytes<D>();
  // once per instantiation (thread-safe static init), so that a launch does
  // nothing but launch: it can then be captured in a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  flash_f32_kernel<D><<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int coserve_flash_attention(
    const void* q, const void* k, const void* v, void* out, int batch,
    int num_heads, int num_kv_heads, int seq_q, int seq_k, int head_dim,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, int bf16, void* stream) {
  if (batch <= 0 || num_heads <= 0 || num_kv_heads <= 0 ||
      num_heads % num_kv_heads != 0 || seq_q <= 0 || seq_k < seq_q ||
      window < 0 || batch > 65535 || num_heads > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.S = seq_q;
  p.T = seq_k;
  p.group = num_heads / num_kv_heads;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.o_sb = o_sb, p.o_sh = o_sh, p.o_ss = o_ss;
  p.causal = causal;
  p.window = window;
  p.scale = (float)(1.0 / std::sqrt((double)head_dim));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)launch<32>(q, k, v, out, p, batch, num_heads, bf16, s);
    case 64:
      return (int)launch<64>(q, k, v, out, p, batch, num_heads, bf16, s);
    case 96:
      return (int)launch<96>(q, k, v, out, p, batch, num_heads, bf16, s);
    case 128:
      return (int)launch<128>(q, k, v, out, p, batch, num_heads, bf16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* coserve_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
