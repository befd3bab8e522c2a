// Residual add and LayerNorm or RMSNorm over the last dimension, written by
// hand for Hopper (sm_90a).
//
// It replaces no TPU kernel. The JAX package leaves this chain to XLA, which
// fuses it into one loop on the TPU; the port runs eagerly, where each step
// of the chain launched a kernel of its own (14 for a LayerNorm, 9 for an
// RMSNorm, one more for the residual add before it). A 128-token forward of
// a served expert is bound by the host's launches (PERF.md), so the chain is
// one launch here.
//
// What it computes, for each row of x [rows, d] (and of delta [rows, d]
// where one is given), in float32 as the plain chain (../ref.py,
// add_norm_ref) computes it:
//   s = x + delta, rounded to x's dtype and written out (the residual
//       stream); without a delta s is x and nothing is written;
//   layernorm: mu = mean(s), var = mean((s - mu)^2),
//              out = (s - mu) * rsqrt(var + eps) * scale + bias;
//   rmsnorm:   var = mean(s * s), out = s * rsqrt(var + eps) * scale;
// each product and sum rounded on its own, as the chain's separate kernels
// round them (no fused multiply-adds), and out rounded once to x's dtype.
// The sums run in another order than torch's reductions, so out agrees
// with the chain to a rounding of its last bit.
//
// What bounds it: bytes. Each element is read once and written once (x and
// delta in, s and out out); at StarCoder2-3B's 1024 x 3072 bf16 rows with a
// delta that is 25.2 MB, 7.5 us at 3.35 TB/s.
//
// Design: one block a row. Each thread holds kV groups of 8 neighbouring
// elements in registers (one 16-byte load of bf16, two of float32), so the
// row is read from memory once and both passes of the LayerNorm (the mean,
// then the deviations) run over registers rather than as E[x^2] - mu^2. A
// block-wide sum is a warp's shuffle tree, then one word a warp through
// shared memory, which every thread adds up in the same order. kV (1, 2 or
// 4) is the smallest that keeps a block within 1024 threads: 384 threads a
// row at d 3072, 512 at d 4096, so that a block's loads are all in flight
// at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kGroup = 8;          // elements a thread loads at once
constexpr int kMaxThreads = 1024;

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

// 8 elements of T at p (16-byte aligned) as float32.
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

// 8 float32 values rounded to T, stored at p (16-byte aligned).
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

// The sum of v over the block, the same in every thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (blockDim.x >> 5); ++w) total += red[w];
  __syncthreads();                 // red is written again by the next sum
  return total;
}

template <typename T, typename P, int kV, bool kDelta, bool kLayer>
__global__ void __launch_bounds__(kMaxThreads)
    add_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                    const P* __restrict__ scale, const P* __restrict__ bias,
                    T* __restrict__ sum_out, T* __restrict__ out, int d,
                    long long x_rs, long long delta_rs, float eps) {
  __shared__ float red[kMaxThreads / 32];
  const long long row = blockIdx.x;
  const int groups = d / kGroup;
  const float inv_d = 1.0f / static_cast<float>(d);
  float v[kV][kGroup];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int g = threadIdx.x + j * blockDim.x;
    if (g < groups) {
      load8(x + row * x_rs + g * kGroup, v[j]);
      if constexpr (kDelta) {
        float dv[kGroup];
        load8(delta + row * delta_rs + g * kGroup, dv);
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          v[j][i] = to_f32(from_f32<T>(__fadd_rn(v[j][i], dv[i])));
        store8(sum_out + row * d + g * kGroup, v[j]);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        acc = kLayer ? __fadd_rn(acc, v[j][i])
                     : __fadd_rn(acc, __fmul_rn(v[j][i], v[j][i]));
    }
  }
  float mu = 0.f;
  if constexpr (kLayer) {
    mu = __fmul_rn(block_sum(acc, red), inv_d);
    acc = 0.f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      if (threadIdx.x + j * blockDim.x < groups) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const float dev = __fsub_rn(v[j][i], mu);
          acc = __fadd_rn(acc, __fmul_rn(dev, dev));
        }
      }
    }
  }
  const float var = __fmul_rn(block_sum(acc, red), inv_d);
  const float r = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int g = threadIdx.x + j * blockDim.x;
    if (g < groups) {
      float sc[kGroup], o[kGroup];
      load8(scale + g * kGroup, sc);
      if constexpr (kLayer) {
        float bi[kGroup];
        load8(bias + g * kGroup, bi);
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          o[i] = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(v[j][i], mu), r), sc[i]), bi[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          o[i] = __fmul_rn(__fmul_rn(v[j][i], r), sc[i]);
      }
      store8(out + row * d + g * kGroup, o);
    }
  }
}

struct Args {
  const void *x, *delta, *scale, *bias;
  void *sum_out, *out;
  long long rows, x_rs, delta_rs;
  int d;
  float eps;
};

template <typename T, typename P, int kV, bool kDelta, bool kLayer>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int groups = a.d / kGroup;
  const int threads = ((groups + kV - 1) / kV + 31) / 32 * 32;
  add_norm_kernel<T, P, kV, kDelta, kLayer>
      <<<static_cast<unsigned>(a.rows), threads, 0, stream>>>(
          static_cast<const T*>(a.x), static_cast<const T*>(a.delta),
          static_cast<const P*>(a.scale), static_cast<const P*>(a.bias),
          static_cast<T*>(a.sum_out), static_cast<T*>(a.out), a.d, a.x_rs,
          a.delta_rs, a.eps);
  return cudaGetLastError();
}

template <typename T, typename P, int kV>
cudaError_t dispatch_kind(const Args& a, bool layer, cudaStream_t stream) {
  const bool with_delta = a.delta != nullptr;
  if (layer)
    return with_delta ? launch<T, P, kV, true, true>(a, stream)
                      : launch<T, P, kV, false, true>(a, stream);
  return with_delta ? launch<T, P, kV, true, false>(a, stream)
                    : launch<T, P, kV, false, false>(a, stream);
}

template <typename T, typename P>
cudaError_t dispatch_v(const Args& a, bool layer, cudaStream_t stream) {
  const int groups = a.d / kGroup;
  if (groups <= kMaxThreads) return dispatch_kind<T, P, 1>(a, layer, stream);
  if (groups <= 2 * kMaxThreads)
    return dispatch_kind<T, P, 2>(a, layer, stream);
  if (groups <= 4 * kMaxThreads)
    return dispatch_kind<T, P, 4>(a, layer, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// x (and delta, or null) [rows, d] with row strides x_rs and delta_rs in
// elements and unit element stride; scale and bias (null for rmsnorm) [d];
// sum_out (written with a delta) and out contiguous [rows, d]. x, delta,
// sum_out and out share one dtype (x_bf16), scale and bias another (p_bf16).
// Returns a cudaError_t: nonzero when the launch was refused.
extern "C" int coserve_add_norm(const void* x, const void* delta,
                                const void* scale, const void* bias,
                                void* sum_out, void* out, long long rows,
                                int d, long long x_rs, long long delta_rs,
                                float eps, int layer, int x_bf16, int p_bf16,
                                void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < kGroup || d % kGroup)
    return cudaErrorInvalidValue;
  if (layer && bias == nullptr) return cudaErrorInvalidValue;
  const int elem = x_bf16 ? 2 : 4;
  if (!aligned16(x) || !aligned16(scale) || !aligned16(out) ||
      (bias && !aligned16(bias)) || x_rs * elem % 16 ||
      (delta && (!aligned16(delta) || !aligned16(sum_out) ||
                 delta_rs * elem % 16)))
    return cudaErrorInvalidValue;
  const Args a{x, delta, scale, bias, sum_out, out, rows, x_rs, delta_rs, d,
               eps};
  auto s = static_cast<cudaStream_t>(stream);
  const bool ln = layer != 0;
  if (x_bf16)
    return p_bf16 ? dispatch_v<bf16, bf16>(a, ln, s)
                  : dispatch_v<bf16, float>(a, ln, s);
  return p_bf16 ? dispatch_v<float, bf16>(a, ln, s)
                : dispatch_v<float, float>(a, ln, s);
}

extern "C" const char* coserve_add_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
