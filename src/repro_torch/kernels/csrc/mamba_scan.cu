// Mamba-1 selective scan, written by hand for Hopper (sm_90a). It replaces
// the Pallas TPU kernel src/repro/kernels/mamba_scan.py::mamba_scan (body
// _scan_kernel) and computes what that kernel computes: for x, dt [B,S,D],
// B, C [B,S,N], A [D,N] and D [D], the state h [D,N] of each batch row
// starts at zero and runs over the sequence in order,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,
//   y_t = sum_n C_t[n] * h_t[:, n] + D * x_t,
// in float32; y is written in x's dtype and the final state h_S [B,D,N] in
// float32.
//
// What bounds it: at Falcon-Mamba's prefill (B 1, S 4096, D 8192, N 16, x
// and y bf16, dt B C float32) the kernel moves ~269 MB (80 us at 3.35 TB/s)
// and evaluates B*S*D*N = 537 M exponentials, each with ~5 float32
// operations around it (~56 us of the card's float32 rate); the
// exponentials go to the SFU, 16 a clock per SM, which takes ~130 us. The
// sequence must be walked in order, so the parallelism is B * D * N.
// What the design does about that:
//   * the state is spread: each thread holds R = min(N, 4) states of one
//     channel and L = N / R neighbouring lanes share a channel, so B 1 at
//     D 8192 and N 16 gives 32 K threads (~8 warps an SM); exp(dt * A) and
//     dt * x * B do not depend on h and are issued ahead of the one
//     dependent FMA a state, and a step ends with the thread's partial sum
//     of C * h written to shared memory, so the loop over the steps holds
//     no shuffle and no other dependence between lanes;
//   * a block of 128 threads owns CH = 128 / L channels of one batch row
//     and walks S in chunks of T steps; x, dt (a [T, CH] tile each) and B,
//     C (a [T, N] tile each, shared by every channel of the block) come in
//     coalesced, one chunk ahead into registers, are converted to float32
//     into shared memory; after the chunk's steps the L partial sums of
//     each (step, channel) are added and y leaves coalesced, [T, CH] at a
//     time;
//   * nothing is padded: the last chunk stops at S and channels past D are
//     masked, so the wrapper hands over its tensors as they are (x, dt, B
//     and C through their batch and sequence strides, the last dimension
//     contiguous);
//   * exp(dt * A) is 2^(dt * (A * log2 e)) by one ex2.approx.ftz (relative
//     error ~2^-22; a decay below 2^-126 becomes zero, dropping a share of
//     h smaller than 2^-126 of it), A * log2 e folded in once a state;
//     float32 throughout, so the kernel stays within float32 rounding of
//     the plain version over thousands of steps.
// Later work: longer chunks (fewer barriers and partial-sum passes a step),
// part of the exponentials by polynomial on the FMA units, B and C staged
// by cp.async/TMA.
//
// Plain C interface, loaded with ctypes (see ../mamba_scan.py):
//   int coserve_mamba_scan(x, dt, b, c, a, d, y, h, B, S, D, N,
//                          x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss,
//                          x_bf16, dt_bf16, bc_bf16, stream)
//     strides in elements; y [B,S,D] and h [B,D,N] contiguous; a, d float32
//     contiguous; N a power of two up to 32; dt and b/c each float32 or x's
//     dtype; returns a cudaError_t, 0 when the launch was accepted.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* x;
  const void* dt;
  const void* b;
  const void* c;
  const float* a;
  const float* d;
  void* y;
  float* h;
  int S, D;
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

// Tiling for a state width N (a power of two up to 32).
template <int N>
struct Geometry {
  static constexpr int R = N < 4 ? N : 4;         // states per thread
  static constexpr int L = N / R;                 // lanes per channel
  static constexpr int CH = kThreads / L;         // channels per block
  static constexpr int T = 1024 / CH < 32 ? 1024 / CH : 32;  // steps/chunk
  static constexpr int XPER = T * CH / kThreads;  // x, dt values per thread
  static constexpr int BCPER = (T * N + kThreads - 1) / kThreads;
};

__device__ __forceinline__ float fast_exp2(float v) {
  float out;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(out) : "f"(v));
  return out;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TX, typename TDT, typename TBC, int N>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(Args p) {
  using G = Geometry<N>;
  constexpr int T = G::T, CH = G::CH, R = G::R, L = G::L;
  __shared__ float sx[T * CH];
  __shared__ float sdt[T * CH];
  __shared__ float sb[T * N];
  __shared__ float sc[T * N];
  __shared__ float sp[T * kThreads];  // each thread's partial y a step

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int ch = tid / L;   // this thread's channel within the block
  const int sub = tid % L;  // its lane within the channel's L lanes
  const int d = d0 + ch;
  const bool active = d < p.D;

  const TX* x = static_cast<const TX*>(p.x) + bi * p.x_sb;
  const TDT* dt = static_cast<const TDT*>(p.dt) + bi * p.dt_sb;
  const TBC* bm = static_cast<const TBC*>(p.b) + bi * p.b_sb;
  const TBC* cm = static_cast<const TBC*>(p.c) + bi * p.c_sb;
  TX* y = static_cast<TX*>(p.y) + static_cast<long long>(bi) * p.S * p.D;

  float a2[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a2[r] = active ? p.a[static_cast<long long>(d) * N + sub * R + r] * kLog2e
                   : 0.f;
    h[r] = 0.f;
  }
  // the D skip joins the partial sum of the channel's first lane
  const float dskip = active && sub == 0 ? p.d[d] : 0.f;

  // the next chunk's inputs, raw, in registers: a conversion here would
  // wait for the loads before the current chunk's steps
  TX rx[G::XPER];
  TDT rdt[G::XPER];
  TBC rb[G::BCPER], rc[G::BCPER];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < G::XPER; ++i) {
      const int e = i * kThreads + tid, t = e / CH, c = e % CH;
      if (t0 + t < p.S && d0 + c < p.D) {
        rx[i] = x[(t0 + t) * p.x_ss + d0 + c];
        rdt[i] = dt[(t0 + t) * p.dt_ss + d0 + c];
      } else {
        rx[i] = from_float<TX>(0.f);
        rdt[i] = from_float<TDT>(0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < G::BCPER; ++i) {
      const int e = i * kThreads + tid, t = e / N, n = e % N;
      if (e < T * N && t0 + t < p.S) {
        rb[i] = bm[(t0 + t) * p.b_ss + n];
        rc[i] = cm[(t0 + t) * p.c_ss + n];
      } else {
        rb[i] = from_float<TBC>(0.f);
        rc[i] = from_float<TBC>(0.f);
      }
    }
  };

  const int n_chunks = (p.S + T - 1) / T;
  load(0);
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * T;
    const int steps = min(T, p.S - t0);
    // stage this chunk (every reader of the last one passed the barrier
    // after the previous chunk's steps; the sums after it read only sp)
#pragma unroll
    for (int i = 0; i < G::XPER; ++i) {
      sx[i * kThreads + tid] = to_float(rx[i]);
      sdt[i * kThreads + tid] = to_float(rdt[i]);
    }
#pragma unroll
    for (int i = 0; i < G::BCPER; ++i) {
      const int e = i * kThreads + tid;
      if (e < T * N) {
        sb[e] = to_float(rb[i]);
        sc[e] = to_float(rc[i]);
      }
    }
    __syncthreads();
    if (k + 1 < n_chunks) load(t0 + T);

#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float xv = sx[t * CH + ch];
      const float dtv = sdt[t * CH + ch];
      const float dtx = dtv * xv;
      float da[R], dbx[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        da[r] = fast_exp2(dtv * a2[r]);
        dbx[r] = dtx * sb[t * N + sub * R + r];
      }
      float acc = dskip * xv;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h[r] = fmaf(da[r], h[r], dbx[r]);
        acc = fmaf(h[r], sc[t * N + sub * R + r], acc);
      }
      sp[t * kThreads + tid] = acc;
    }
    __syncthreads();

    // this chunk's y: the L partial sums of each (step, channel), written
    // coalesced over channels
#pragma unroll
    for (int i = 0; i < G::XPER; ++i) {
      const int e = i * kThreads + tid, t = e / CH, c = e % CH;
      if (t < steps && d0 + c < p.D) {
        float sum = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) sum += sp[t * kThreads + c * L + l];
        y[static_cast<long long>(t0 + t) * p.D + d0 + c] = from_float<TX>(sum);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      p.h[(static_cast<long long>(bi) * p.D + d) * N + sub * R + r] = h[r];
  }
}

template <typename TX, typename TDT, typename TBC, int N>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream) {
  using G = Geometry<N>;
  const dim3 grid((p.D + G::CH - 1) / G::CH, batch);
  mamba_scan_kernel<TX, TDT, TBC, N><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename TX, typename TDT, typename TBC>
cudaError_t dispatch_n(const Args& p, int batch, int n, cudaStream_t stream) {
  switch (n) {
    case 1: return launch<TX, TDT, TBC, 1>(p, batch, stream);
    case 2: return launch<TX, TDT, TBC, 2>(p, batch, stream);
    case 4: return launch<TX, TDT, TBC, 4>(p, batch, stream);
    case 8: return launch<TX, TDT, TBC, 8>(p, batch, stream);
    case 16: return launch<TX, TDT, TBC, 16>(p, batch, stream);
    case 32: return launch<TX, TDT, TBC, 32>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int coserve_mamba_scan(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a, const void* d, void* y, void* h, int batch, int seq,
    int dim, int n, long long x_sb, long long x_ss, long long dt_sb,
    long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, int x_bf16, int dt_bf16, int bc_bf16, void* stream) {
  if (batch < 1 || seq < 1 || dim < 1) return cudaErrorInvalidValue;
  Args p{x, dt, b, c, static_cast<const float*>(a),
         static_cast<const float*>(d), y, static_cast<float*>(h), seq, dim,
         x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (!x_bf16) {
    if (dt_bf16 || bc_bf16) return cudaErrorInvalidValue;
    return dispatch_n<float, float, float>(p, batch, n, s);
  }
  if (dt_bf16 && bc_bf16) return dispatch_n<bf16, bf16, bf16>(p, batch, n, s);
  if (dt_bf16) return dispatch_n<bf16, bf16, float>(p, batch, n, s);
  if (bc_bf16) return dispatch_n<bf16, float, bf16>(p, batch, n, s);
  return dispatch_n<bf16, float, float>(p, batch, n, s);
}

extern "C" const char* coserve_mamba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
