// Rotate-half RoPE of the queries and the keys together, in place, written
// by hand for Hopper (sm_90a).
//
// It replaces no TPU kernel. The JAX package leaves RoPE to XLA, which fuses
// it into the projections' epilogue on the TPU; the port runs eagerly, where
// each step of the chain launched a kernel of its own (12 for q and 12 more
// for k: the positions' cast, the angles, cos, sin, four products, the
// difference, the sum, the concatenation and the cast back), and a 128-token
// forward of a served expert is bound by the host's launches (PERF.md). So
// q and k are rotated by one launch here.
//
// What it computes, for q [B,S,Hq,hd] and k [B,S,Hkv,hd] with positions
// [B,S] and the float32 frequencies freqs [hd/2], as the plain chain
// (../ref.py, rope_ref) computes it:
//   angle_i = float(pos) * freqs[i]; c_i = cosf(angle_i); s_i = sinf(angle_i)
//   (the accurate functions, as torch.cos and torch.sin are, not the
//   __cosf intrinsics); then for each head, with x1 the first half of its
//   row and x2 the second,
//   x1' = x1 * c - x2 * s and x2' = x2 * c + x1 * s
// in float32, each product and sum rounded on its own (no fused multiply-
// adds), each result rounded once to the dtype of q and k.
//
// What bounds it: bytes. q and k are read once and written once; at
// StarCoder2-3B's 1024 tokens of 24 query and 2 key heads of 128 in bf16
// that is 13.6 MB, 4.1 us at 3.35 TB/s. The angles are the same for every
// head of a token, so a token's cos and sin are computed once, into shared
// memory, and not once a head.
//
// Design: one block a token. Its threads first compute the token's hd/2
// angles' cos and sin into shared memory, then each thread rotates groups
// of 8 neighbouring pairs (16-byte loads of the two halves in bf16) of one
// head of q or of k, the heads of q and of k in one range of work items.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kGroup = 8;          // pairs a thread rotates at once
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&out)[kGroup]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < kGroup / kPer; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32(e[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[kGroup]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < kGroup / kPer; ++c) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) e[i] = from_f32<T>(v[c * kPer + i]);
    reinterpret_cast<uint4*>(p)[c] = raw;
  }
}

struct Args {
  void *q, *k;
  const long long* pos;
  const float* freqs;
  int seq, hq, hkv, half;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, p_sb, p_ss;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) rope_kernel(const Args a) {
  extern __shared__ float table[];          // [half] cos, then [half] sin
  const int b = blockIdx.x / a.seq, s = blockIdx.x % a.seq;
  const float p = static_cast<float>(a.pos[b * a.p_sb + s * a.p_ss]);
  for (int i = threadIdx.x; i < a.half; i += blockDim.x) {
    const float angle = __fmul_rn(p, a.freqs[i]);
    table[i] = cosf(angle);
    table[a.half + i] = sinf(angle);
  }
  __syncthreads();
  const int chunks = a.half / kGroup;
  const int items = (a.hq + a.hkv) * chunks;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int h = it / chunks, j = (it - h * chunks) * kGroup;
    T* row = h < a.hq
        ? static_cast<T*>(a.q) + b * a.q_sb + s * a.q_ss + h * a.q_sh
        : static_cast<T*>(a.k) + b * a.k_sb + s * a.k_ss + (h - a.hq) * a.k_sh;
    float x1[kGroup], x2[kGroup], o1[kGroup], o2[kGroup];
    load8(row + j, x1);
    load8(row + a.half + j, x2);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float c = table[j + i], sn = table[a.half + j + i];
      o1[i] = __fsub_rn(__fmul_rn(x1[i], c), __fmul_rn(x2[i], sn));
      o2[i] = __fadd_rn(__fmul_rn(x2[i], c), __fmul_rn(x1[i], sn));
    }
    store8(row + j, o1);
    store8(row + a.half + j, o2);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// q [batch, seq, hq, hd] and k [batch, seq, hkv, hd] (one dtype, q_bf16),
// each with a unit stride along hd and the other strides in elements,
// rotated in place; pos [batch, seq] int64 with strides p_sb, p_ss (0 for an
// expanded dim); freqs [hd / 2] float32. Returns a cudaError_t: nonzero when
// the launch was refused.
extern "C" int coserve_rope(void* q, void* k, const void* pos,
                            const void* freqs, int batch, int seq, int hq,
                            int hkv, int hd, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long p_sb, long long p_ss,
                            int q_bf16, void* stream) {
  const long long tokens = static_cast<long long>(batch) * seq;
  if (batch < 1 || seq < 1 || tokens > 0x7fffffffLL || hq < 1 || hkv < 0 ||
      hd < 2 * kGroup || hd % (2 * kGroup))
    return cudaErrorInvalidValue;
  const int elem = q_bf16 ? 2 : 4;
  for (long long st : {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh})
    if (st * elem % 16) return cudaErrorInvalidValue;
  if (!aligned16(q) || (hkv && !aligned16(k))) return cudaErrorInvalidValue;
  const Args a{q, k, static_cast<const long long*>(pos),
               static_cast<const float*>(freqs), seq, hq, hkv, hd / 2,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, p_sb, p_ss};
  const int items = (hq + hkv) * (hd / 2 / kGroup);
  const int threads = items >= kMaxThreads ? kMaxThreads : (items + 31) / 32 * 32;
  const size_t smem = sizeof(float) * hd;
  auto s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    rope_kernel<bf16><<<static_cast<unsigned>(tokens), threads, smem, s>>>(a);
  else
    rope_kernel<float><<<static_cast<unsigned>(tokens), threads, smem, s>>>(a);
  return cudaGetLastError();
}

extern "C" const char* coserve_rope_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
