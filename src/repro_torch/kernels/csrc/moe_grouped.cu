// The expert products of a dropless MoE layer over the experts one card
// holds, grouped by expert, written by hand for Hopper (sm_90a).
//
// It replaces no TPU kernel. The JAX package's MoE layer dispatches into a
// fixed [groups, experts, capacity, d] buffer and drops what overflows, and
// XLA compiles the batched products. A dropless layer gives each expert as
// many rows as its tokens chose it, and that count is known only on the
// device: a loop of library products over the experts would read every
// count on the host, a synchronisation in each MoE layer of each forward.
// Here the counts stay on the device and the grid is sized for the worst
// case (every row on one expert); a tile past its expert's rows exits at
// once.
//
// What it computes (../ref.py, moe_grouped_ref, in float32):
//   the (token, choice) pairs, sorted by the held expert they chose
//   (order[r] = token * k + choice, expert e's rows r in
//   [offsets[e], offsets[e+1])), in two launches:
//   1. h[r] = silu(x[order[r] / k] W_gate[e]) * (x[order[r] / k] W_up[e]),
//      accumulated in float32, rounded once to bf16;
//   2. out[order[r]] = weights[order[r]] * (h[r] W_down[e]), accumulated in
//      float32, scaled in float32, rounded once to bf16.
//   out is zero where no held expert wrote (the caller clears it), so the
//   caller's sum over each token's k places combines the choices in token
//   order, without atomics.
//
// What bounds it: bytes. At the served shapes (8 held experts of d 4096 and
// ff 14336, about 128 rows each) each launch streams its experts' weights
// once, 2.82 GB a layer in all (0.84 ms at 3.35 TB/s), against 0.36 ms of
// tensor-core work at 989 TFLOP/s: 128 rows an expert is below the card's
// ridge (about 295 operations a byte).
//
// Design: one block a (128-row tile of an expert, 128-column tile of the
// output); the block finds its expert by walking the offsets. Blocks with
// consecutive x index share a column tile, so the tiles of one expert that
// need the same weights run side by side and the second read comes from L2.
// A 4-stage cp.async ring holds the A rows (gathered row by row through
// order in launch 1) and the weight tile; 8 warps, each 32 rows by 64
// columns, run mma.sync m16n8k16 (bf16 in, float32 accumulate) from
// ldmatrix fragments. In launch 1 a block's 128 columns are 64 of the gate
// and the same 64 of up, so that each thread holds both halves of its
// outputs for the SwiGLU epilogue. A warp whose 32 rows lie past its
// expert's rows skips its products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;               // rows a tile
constexpr int kBN = 128;               // output columns a tile
constexpr int kBK = 32;                // inner dim a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;          // 8 warps: 4 along rows, 2 along columns
constexpr int kAStride = kBK + 8;      // bf16 a shared A row (conflict-free)
constexpr int kBStride = kBN + 8;      // bf16 a shared B row
constexpr int kATile = kBM * kAStride;
constexpr int kBTile = kBK * kBStride;
constexpr int kAVecs = kBK / 8;        // 16-byte vectors a tile row of A
constexpr int kBVecs = kBN / 8;        // and of B
constexpr int kAPer = kBM * kAVecs / kThreads;   // a thread's, a stage
constexpr int kBPer = kBK * kBVecs / kThreads;
constexpr int kSmem = kStages * (kATile + kBTile) * 2;
constexpr int kMaxExperts = 64;

struct Args {
  const bf16* a;               // launch 1: x [T, d]; launch 2: h [R, ff]
  const long long* order;      // [R]
  const long long* offsets;    // [E + 1]
  const float* weights;        // [R], by pair
  const bf16* w;               // launch 1: w_in [E, d, 2, ff]; 2: w_down [E, ff, d]
  bf16* out;                   // launch 1: h [R, ff]; launch 2: out [R, d]
  int experts, top_k;
  int K;                       // inner dim: d, then ff
  int N;                       // output columns: ff, then d
};

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The shared-tile column of a warp's n8 fragment j (0..7). Launch 1: the
// warp's 32 gate columns (j < 4) and the same 32 up columns (j >= 4), the
// tile's gate half first; launch 2: 64 neighbouring columns.
template <int kMode>
__device__ __forceinline__ int frag_col(int wn, int j) {
  if (kMode == 0) return (j < 4 ? 0 : kBN / 2) + wn * 32 + (j & 3) * 8;
  return wn * 64 + j * 8;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    moe_grouped_kernel(Args p) {
  // this block's expert and rows: the tiles of experts 0, 1, ... in turn
  int tile = blockIdx.x, e = 0;
  long long row0 = 0, row_end = 0;
  for (; e < p.experts; ++e) {
    const long long lo = p.offsets[e], hi = p.offsets[e + 1];
    const int tiles = static_cast<int>((hi - lo + kBM - 1) / kBM);
    if (tile < tiles) {
      row0 = lo + static_cast<long long>(tile) * kBM;
      row_end = hi;
      break;
    }
    tile -= tiles;
  }
  if (e == p.experts) return;  // past every expert's rows

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + kStages * kATile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int nb = blockIdx.y;

  // this thread's 16-byte vectors of each stage's A tile and B tile
  const bf16* a_src[kAPer];
  bool a_ok[kAPer];
  int a_dst[kAPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int c = i * kThreads + tid, r = c / kAVecs, j = c % kAVecs;
    const long long row = row0 + r;
    a_ok[i] = row < row_end;
    long long src_row = 0;
    if (a_ok[i]) src_row = kMode == 0 ? p.order[row] / p.top_k : row;
    a_src[i] = p.a + src_row * p.K + j * 8;
    a_dst[i] = r * kAStride + j * 8;
  }
  const long long ldb = kMode == 0 ? 2LL * p.N : p.N;
  const bf16* w_e = p.w + static_cast<long long>(e) * p.K * ldb;
  const bf16* b_src[kBPer];
  int b_dst[kBPer];
#pragma unroll
  for (int i = 0; i < kBPer; ++i) {
    const int c = i * kThreads + tid, kr = c / kBVecs, cv = (c % kBVecs) * 8;
    long long col;
    if (kMode == 0)  // gate columns, then the same up columns
      col = (cv < kBN / 2 ? 0 : p.N) + nb * (kBN / 2) + (cv & (kBN / 2 - 1));
    else
      col = static_cast<long long>(nb) * kBN + cv;
    b_src[i] = w_e + kr * ldb + col;
    b_dst[i] = kr * kBStride + cv;
  }

  auto load_stage = [&](int stage, int kt) {
    bf16* a_s = sa + stage * kATile;
    bf16* b_s = sb + stage * kBTile;
    const long long ka = static_cast<long long>(kt) * kBK;
#pragma unroll
    for (int i = 0; i < kAPer; ++i)
      cp_async16(a_s + a_dst[i], a_ok[i] ? a_src[i] + ka : p.a, a_ok[i]);
#pragma unroll
    for (int i = 0; i < kBPer; ++i)
      cp_async16(b_s + b_dst[i], b_src[i] + ka * ldb, true);
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;

  const bool active = row0 + wm * 32 < row_end;  // warp-uniform
  const int kt_count = p.K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free for all
    const int next = kt + kStages - 1;
    if (next < kt_count) load_stage(next % kStages, next);
    cp_async_commit();  // possibly empty: keeps the group count uniform

    if (active) {
      const bf16* a_s = sa + (kt % kStages) * kATile;
      const bf16* b_s = sb + (kt % kStages) * kBTile;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(af[mi], a_s + (wm * 32 + mi * 16 + (lane & 15)) *
                                        kAStride +
                                  ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, b_s + (ks * 16 + (lane & 15)) * kBStride +
                                    frag_col<kMode>(wn, 2 * jp) +
                                    (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * jp], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][2 * jp + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  // epilogue: fragment (mi, j) holds rows g and g + 8 of its 16, columns
  // 2 * (lane % 4) and the next one of its 8
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = row0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= row_end) continue;
      if (kMode == 0) {
        bf16* dst = p.out + row * p.N + nb * (kBN / 2) + wn * 32 + c2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float gate = acc[mi][j][half * 2 + q];
            const float up = acc[mi][j + 4][half * 2 + q];
            v[q] = gate / (1.f + __expf(-gate)) * up;
          }
          *reinterpret_cast<uint32_t*>(dst + j * 8) = pack_bf16(v[0], v[1]);
        }
      } else {
        const long long pair = p.order[row];
        const float wgt = p.weights[pair];
        bf16* dst = p.out + pair * p.N + static_cast<long long>(nb) * kBN +
                    wn * 64 + c2;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + j * 8) =
              pack_bf16(acc[mi][j][half * 2] * wgt,
                        acc[mi][j][half * 2 + 1] * wgt);
      }
    }
  }
}

template <int kMode>
cudaError_t launch(const Args& a, long long rows, cudaStream_t stream) {
  // once per instantiation (thread-safe static init), so that a launch does
  // nothing but launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_grouped_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  // worst case: every tile of every expert, each expert's last one partial
  const long long tiles = (rows + kBM - 1) / kBM + a.experts;
  const int col_tiles = kMode == 0 ? a.N / (kBN / 2) : a.N / kBN;
  moe_grouped_kernel<kMode>
      <<<dim3(static_cast<unsigned>(tiles), col_tiles), kThreads, kSmem,
         stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x [tokens, d], order [rows], offsets [experts + 1], weights [rows] (by
// pair), w_in [experts, d, 2, ff], w_down [experts, ff, d], h [rows, ff]
// (scratch), out [rows, d] (cleared by the caller); rows = tokens * top_k.
extern "C" int coserve_moe_grouped(const void* x, const void* order,
                                   const void* offsets, const void* weights,
                                   const void* w_in, const void* w_down,
                                   void* h, void* out, long long rows,
                                   long long tokens, int d, int ff,
                                   int experts, int top_k, void* stream) {
  if (rows < 1 || rows != tokens * top_k || top_k < 1 || experts < 1 ||
      experts > kMaxExperts || d < kBN || d % kBN || ff < kBN || ff % kBN ||
      (rows + kBM - 1) / kBM + experts > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w_in) || !aligned16(w_down) ||
      !aligned16(h) || !aligned16(out))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ord = static_cast<const long long*>(order);
  const auto* off = static_cast<const long long*>(offsets);
  const auto* wt = static_cast<const float*>(weights);
  const Args up{static_cast<const bf16*>(x), ord, off, wt,
                static_cast<const bf16*>(w_in), static_cast<bf16*>(h),
                experts, top_k, d, ff};
  cudaError_t err = launch<0>(up, rows, s);
  if (err != cudaSuccess) return err;
  const Args down{static_cast<const bf16*>(h), ord, off, wt,
                  static_cast<const bf16*>(w_down), static_cast<bf16*>(out),
                  experts, top_k, ff, d};
  return launch<1>(down, rows, s);
}

extern "C" const char* coserve_moe_grouped_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
