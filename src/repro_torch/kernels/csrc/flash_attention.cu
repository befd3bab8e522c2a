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
// every K and V element read feeds 128 query rows' products per block, far
// above the card's ~295 bf16 operations per byte of device memory, so the
// tensor cores are the limit (4 * B * H * D operations per unmasked q-k
// pair). Hopper reaches its tensor-core rate only through wgmma, fed from
// shared memory that TMA fills, so the bf16 prefill path is built on those:
//
// flash_wgmma_kernel (bf16, D 64 and 128, the prefill shapes):
//   * one block per (128-row q tile, batch, query head): two consumer
//     warpgroups of 64 q rows each and a producer warpgroup, of which one
//     thread issues every load; setmaxnreg gives the producer 24 registers
//     and each consumer 240 (S and O take 64 float32 registers each at
//     D 128, P 32 more);
//   * TMA (cp.async.bulk.tensor, 4-D maps over the strided [B,H,S,D] view,
//     built per call on the host) brings Q once and K and V in tiles of 128
//     keys into a ring of three stages, each operand as D/64 boxes of 64
//     columns with the 128-byte swizzle; every stage has a full and an empty
//     mbarrier for K and for V, so S = Q K^T starts while V still lands. At
//     D 128 that is 32 KB of Q and 3 x 64 KB of K and V, 225 of the 227 KB a
//     block may have; 128 keys keep S in 64 registers a thread (176 would
//     need 88);
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory (K
//     is K-major as it lies); P, packed to bf16 in the accumulator's own
//     layout, which is wgmma's A-fragment layout, feeds O += P V, wgmma
//     m64nDk16 with A from registers and V from shared memory through the
//     transposed-B (N-major) descriptor, so P and O never touch shared
//     memory;
//   * the products of a warpgroup are software-pipelined: S of tile i is
//     issued with P V of tile i - 1, and the online softmax of tile i (in
//     float32, base 2, one FFMA and one ex2 an element) runs while P V of
//     tile i - 1 is still on the tensor cores; the two warpgroups take turns
//     to issue (named barriers), so that one's softmax also overlaps the
//     other's products. The loop's first and last turns are peeled off, so
//     that ptxas can keep the wgmma pipeline without serializing it;
//   * key tiles run between the causal and window limits of the block's
//     first and last row; only tiles on the diagonal or the window edge pay
//     for the per-element mask; the q tiles are launched latest (longest)
//     first;
//   * TMA zero-fills rows past S or T, so the wrapper pads nothing; the
//     output is stored from registers, clipped to S.
//   Left for later: a persistent scheduler (each block's prologue, Q and
//   the first K tile, is not overlapped with another block's tail) and
//   storing O through shared memory and TMA.
//
// flash_bf16_kernel (bf16, short q and D 32 and 96): four warps, 64-row q
// tiles, mma.sync m16n8k16 with Q, S and O in registers, K and V by
// cp.async. The wrapper picks it where it beats the wgmma kernel: for short
// q (the router's 16-token prompts) and for D 32 and 96, which the 64-column
// swizzled boxes do not tile. The crossover, measured on an NVIDIA H100
// 80GB HBM3 at 700 W, is written beside WGMMA_MIN_SEQ in
// ../flash_attention.py.
//
// flash_f32_kernel (float32, the parity path): plain FMA on the CUDA cores
// (no TF32, so float32 stays exact to ~1e-6), tiles of 32 keys through
// shared memory.
//
// Every kernel masks its ragged edges itself and reads q, k, v and writes
// out through their strides (the last dimension contiguous), so the
// transposed views the transformer hands over need no copy.
//
// Plain C interface, loaded with ctypes (see ../flash_attention.py):
//   int coserve_flash_attention(q, k, v, out, B, H, Hkv, S, T, D,
//                               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
//                               v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
//                               causal, window, route, stream)
//     strides in elements; route 0: float32 (flash_f32_kernel), 1: bf16 by
//     mma.sync (D 32, 64, 96, 128), 2: bf16 by wgmma (D 64, 128); returns a
//     cudaError_t, 0 when the launch was accepted (cudaErrorNotSupported
//     when the driver offers no tensor-map encoder, cudaErrorInvalidValue
//     when a view cannot be mapped).
//
// The tensor maps are encoded by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links no libcuda.
#include <cuda.h>
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

// ------------------------------------------------------------------------ //
// bf16 prefill: wgmma, TMA, warp specialization
// ------------------------------------------------------------------------ //

constexpr int kWgRows = 128;     // q rows a block: two consumer warpgroups
constexpr int kWgKeys = 128;     // keys a tile: S is m64n128 per warpgroup
constexpr int kWgStages = 3;     // K and V tiles in flight
constexpr int kWgThreads = 384;  // producer warpgroup + two consumers
constexpr int kBoxCols = 64;     // bf16 columns of one 128-byte swizzled row
constexpr int kBoxRowBytes = 128;
// below this, a scaled row maximum is a masked score's (-1e30 times a
// scale of 0.13-0.18 at D 128-64), not a real one
constexpr float kMaskedMax = -1e20f;

template <int D>
struct WgSmem {
  // each tile is D / 64 boxes [rows][64] one after the other, every box
  // 1024-byte aligned as the 128-byte swizzle requires
  __nv_bfloat16 q[kWgRows * D];
  __nv_bfloat16 k[kWgStages][kWgKeys * D];
  __nv_bfloat16 v[kWgStages][kWgKeys * D];
  uint64_t q_full;
  uint64_t k_full[kWgStages], k_empty[kWgStages];
  uint64_t v_full[kWgStages], v_empty[kWgStages];
};

template <int D>
constexpr size_t wg_smem_bytes() {
  return sizeof(WgSmem<D>) + 1024;  // slack to align the base to 1024
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
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

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lead,
                                            uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keeps the compiler from touching accumulator registers across a wgmma
// that is still in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64] (+)= A[64x16] * B[16x128], both from shared memory by descriptor
// (K-major, 128-byte swizzle); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64] += A[64x16] * B[16x128]: A from registers (the m16n8k16 A-fragment
// layout, per warp), B from shared memory by descriptor, N-major
// (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[32] += A[64x16] * B[16x64]: A from registers (the m16n8k16 A-fragment
// layout, per warp), B from shared memory by descriptor, N-major
// (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  wgmma_rs_n128_tb(o, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  wgmma_rs_n64_tb(o, a, desc_b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers over the 256 consumer threads: one warpgroup waits, the
// other arrives.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// A consumer thread's two rows (r0 and r0 + 8 of its warp's 16) and their
// online-softmax state, in base 2.
struct Rows {
  int qpos0;          // position of row r0; row r0 + 8 sits 8 later
  int cq0, cq1;       // the warpgroup's valid q rows [cq0, cq1)
  int tg;             // lane % 4: keys 8 j + 2 tg (+1) of each n8 tile
  float scale;        // softmax scale times log2(e)
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
};

// The online softmax over one key tile of S (m64n128 accumulator: rows r0
// in s[4j], s[4j+1] and r0 + 8 in s[4j+2], s[4j+3]): masks, leaves the
// exponentials of the scaled scores in s (one FFMA and one ex2 each),
// updates m and l and returns the factors that bring O to the new row
// maxima.
__device__ __forceinline__ void softmax_tile(float (&s)[kWgKeys / 2],
                                             Rows& r, const Params& p,
                                             int k0, float& alpha0,
                                             float& alpha1) {
  const bool masked = tile_has_mask(p, r.cq0, r.cq1, k0, kWgKeys);
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < kWgKeys / 8; ++j) {
    if (masked) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!key_visible(p, e < 2 ? r.qpos0 : r.qpos0 + 8,
                         k0 + 8 * j + 2 * r.tg + (e & 1)))
          s[4 * j + e] = kNegInf;
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  // a row's 128 scores lie in the four lanes of its quad
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  // the raw scores' maxima, scaled (scale > 0); a masked score, -1e30 raw,
  // stays far below any real one once scaled. A row that has met no
  // visible key yet takes 0 as its exponent base, so that its masked
  // scores give exactly 0 (with their own maximum as the base, the FFMA's
  // rounding residue would be ~1e22); its first visible key's alpha wipes
  // nothing but zeros
  const float n0 = fmaxf(r.m0, mx0 * r.scale), n1 = fmaxf(r.m1, mx1 * r.scale);
  const float b0 = n0 < kMaskedMax ? 0.f : n0;
  const float b1 = n1 < kMaskedMax ? 0.f : n1;
  alpha0 = ex2(r.m0 - n0);
  alpha1 = ex2(r.m1 - n1);
  r.m0 = n0;
  r.m1 = n1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kWgKeys / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], r.scale, -b0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], r.scale, -b0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], r.scale, -b1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], r.scale, -b1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  r.l0 = r.l0 * alpha0 + sum0;
  r.l1 = r.l1 * alpha1 + sum1;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ out, Params p) {
  constexpr int kBoxes = D / kBoxCols;
  constexpr int kTileBytes = kWgKeys * D * 2;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  WgSmem<D>& sm = *reinterpret_cast<WgSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_wg) + 1023) & ~uintptr_t(1023));

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // latest (longest) tiles first
  const int q0 = qt * kWgRows, q1 = min(q0 + kWgRows, p.S);
  const int kvh = h / p.group;
  int lo, hi;
  key_range(p, q0, q1, lo, hi);
  const int first = lo / kWgKeys * kWgKeys;
  const int n_tiles = first < hi ? (hi - first + kWgKeys - 1) / kWgKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&sm.v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kWgRows * D * 2);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(sm.q + c * kWgRows * kBoxCols, &map_q, &sm.q_full,
                 c * kBoxCols, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kWgStages;
        const uint32_t ph = (i / kWgStages) & 1;
        const int k0 = first + i * kWgKeys;
        mbar_wait(&sm.k_empty[st], ph ^ 1);
        mbar_expect_tx(&sm.k_full[st], kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(sm.k[st] + c * kWgKeys * kBoxCols, &map_k,
                   &sm.k_full[st], c * kBoxCols, k0, kvh, b);
        mbar_wait(&sm.v_empty[st], ph ^ 1);
        mbar_expect_tx(&sm.v_full[st], kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(sm.v[st] + c * kWgKeys * kBoxCols, &map_v,
                   &sm.v_full[st], c * kBoxCols, k0, kvh, b);
      }
    }
    return;
  }

  // consumers: warpgroup c holds q rows [64 c, 64 c + 64) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const int r0 = c * 64 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  Rows rows;
  rows.qpos0 = q0 + r0 + p.T - p.S;
  rows.cq0 = q0 + c * 64;
  rows.cq1 = min(rows.cq0 + 64, p.S);
  rows.scale = p.scale * 1.4426950408889634f;  // scores in base 2
  rows.tg = tg;

  const uint32_t q_addr = smem_addr(sm.q) + c * 64 * kBoxRowBytes;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[kWgKeys / 2];
  uint32_t pa[kWgKeys / 16][4];

  // S = Q K^T: D / 16 steps of k16; a step advances 32 bytes inside a
  // 128-byte swizzled row, a box every four steps
  auto issue_s = [&](int st) {
    const uint32_t k_addr = smem_addr(sm.k[st]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t a = q_addr + (ks / 4) * kWgRows * kBoxRowBytes +
                         (ks % 4) * 32;
      const uint32_t bk = k_addr + (ks / 4) * kWgKeys * kBoxRowBytes +
                          (ks % 4) * 32;
      wgmma_ss_n128(s, wg_desc(a, 16, 1024), wg_desc(bk, 16, 1024),
                    ks > 0);
    }
    wgmma_commit();
  };
  // O += P V: kWgKeys / 16 steps of k16; V is N-major, so a step is 16
  // rows of 128 bytes, the next 64 columns lie one box (kWgKeys rows)
  // further, and 8-row groups are 1024 bytes apart
  auto issue_pv = [&](int st) {
    const uint32_t v_addr = smem_addr(sm.v[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgKeys / 16; ++kk)
      wgmma_pv<D>(o, pa[kk],
                  wg_desc(v_addr + kk * 16 * kBoxRowBytes,
                          kWgKeys * kBoxRowBytes, 1024));
    wgmma_commit();
  };
  // O so far is relative to the old row maxima: bring it to the new ones;
  // then P of the tile, in the accumulator's own layout, is the A fragment
  // of the next P V (key tiles 2 kk and 2 kk + 1)
  auto rescale_and_pack = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      o[4 * jd] *= alpha0;
      o[4 * jd + 1] *= alpha0;
      o[4 * jd + 2] *= alpha1;
      o[4 * jd + 3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < kWgKeys / 8; ++j) {
      pa[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };
  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2), so that one's softmax runs while the other's products do;
  // warpgroup 0 goes first, and each passes the turn on after issuing.
  // Turn 0 issues S of tile 0, turn i S of tile i and P V of tile i - 1,
  // turn n P V of tile n - 1; the first and the last are peeled off the
  // loop, so that every wgmma and every wait in it runs unconditionally.
  const int my_turn = 1 + c, other_turn = 2 - c;
  mbar_wait(&sm.q_full, 0);
  if (n_tiles > 0) {
    float alpha0, alpha1;
    if (c == 1) named_arrive(other_turn);  // warpgroup 0 goes first
    mbar_wait(&sm.k_full[0], 0);
    named_sync(my_turn);
    issue_s(0);
    named_arrive(other_turn);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.k_empty[0]);
    softmax_tile(s, rows, p, first, alpha0, alpha1);
    rescale_and_pack(alpha0, alpha1);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kWgStages, pst = (i - 1) % kWgStages;
      mbar_wait(&sm.k_full[st], (i / kWgStages) & 1);
      mbar_wait(&sm.v_full[pst], ((i - 1) / kWgStages) & 1);
      named_sync(my_turn);
      issue_s(st);
      issue_pv(pst);
      named_arrive(other_turn);
      wgmma_wait<1>();  // S of tile i; P V of tile i - 1 may still run
      fence_regs(s);
      if (lane == 0) mbar_arrive(&sm.k_empty[st]);
      softmax_tile(s, rows, p, first + i * kWgKeys, alpha0, alpha1);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&sm.v_empty[pst]);
      rescale_and_pack(alpha0, alpha1);
    }
    const int pst = (n_tiles - 1) % kWgStages;
    mbar_wait(&sm.v_full[pst], ((n_tiles - 1) / kWgStages) & 1);
    named_sync(my_turn);
    issue_pv(pst);
    if (c == 0) named_arrive(other_turn);  // warpgroup 1 has no next turn
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&sm.v_empty[pst]);
  }

  const float inv0 = 1.f / fmaxf(rows.l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(rows.l1, 1e-30f);
  __nv_bfloat16* o_blk = out + b * p.o_sb + h * p.o_sh;
  const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + 2 * tg;
    if (row0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(o_blk + row0 * p.o_ss + d) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(o_blk + row1 * p.o_ss + d) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// ------------------------------------------------------------------------ //
// host side
// ------------------------------------------------------------------------ //

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no -lcuda; null if the driver does not offer it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 [batch][heads][rows][D] view with element strides (row, head,
// batch), as dims (D, rows, heads, batch) in boxes of [box_rows][64]. The
// stride of a dimension of extent 1 is never used; it is set to a valid one.
cudaError_t make_map(CUtensorMap* map, const void* base, int d, int rows,
                     int heads, int batch, long long s_row, long long s_head,
                     long long s_batch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  long long st[3] = {s_row, s_head, s_batch};
  long long dense = d;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) st[i] = dense;
    dense = st[i] * (long long)dims[i + 1];
  }
  const cuuint64_t strides[3] = {(cuuint64_t)st[0] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Params& p, int batch, int heads, int route,
                   cudaStream_t stream) {
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, heads, batch);
  if (route == 1) {
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

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, const Params& p, int batch, int heads,
                         int kv_heads, cudaStream_t stream) {
  // the maps are kernel parameters, copied at launch (and into a graph)
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, D, p.S, heads, batch, p.q_ss, p.q_sh,
                             p.q_sb, kWgRows);
  if (err == cudaSuccess)
    err = make_map(&mk, k, D, p.T, kv_heads, batch, p.k_ss, p.k_sh, p.k_sb,
                   kWgKeys);
  if (err == cudaSuccess)
    err = make_map(&mv, v, D, p.T, kv_heads, batch, p.v_ss, p.v_sh, p.v_sb,
                   kWgKeys);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = wg_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  // heads, then batch, then the q tiles latest first, in launch order
  const dim3 grid(heads, batch, (p.S + kWgRows - 1) / kWgRows);
  flash_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int coserve_flash_attention(
    const void* q, const void* k, const void* v, void* out, int batch,
    int num_heads, int num_kv_heads, int seq_q, int seq_k, int head_dim,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, int route, void* stream) {
  if (batch <= 0 || num_heads <= 0 || num_kv_heads <= 0 ||
      num_heads % num_kv_heads != 0 || seq_q <= 0 || seq_k < seq_q ||
      window < 0 || batch > 65535 || num_heads > 65535 || route < 0 ||
      route > 2)
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
  if (route == 2) {
    switch (head_dim) {
      case 64:
        return (int)launch_wgmma<64>(q, k, v, out, p, batch, num_heads,
                                     num_kv_heads, s);
      case 128:
        return (int)launch_wgmma<128>(q, k, v, out, p, batch, num_heads,
                                      num_kv_heads, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (head_dim) {
    case 32:
      return (int)launch<32>(q, k, v, out, p, batch, num_heads, route, s);
    case 64:
      return (int)launch<64>(q, k, v, out, p, batch, num_heads, route, s);
    case 96:
      return (int)launch<96>(q, k, v, out, p, batch, num_heads, route, s);
    case 128:
      return (int)launch<128>(q, k, v, out, p, batch, num_heads, route, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* coserve_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
