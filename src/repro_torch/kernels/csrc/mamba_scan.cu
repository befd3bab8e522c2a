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
// and y bf16, dt B C float32) the call moves ~270 MB (81 us at 3.35 TB/s)
// and evaluates B*S*D*N = 537 M exponentials, each with ~6 float32
// operations around it; the exponentials go to the SFU, 16 a clock per SM,
// which takes ~130 us. The recurrence is a chain in t for each (b, d, n),
// so a kernel that walks it in order has only B*D*N = 131 K chains: 8 warps
// an SM, each waiting on its own FMA and exponential latencies. Throwaway
// variants of that kernel (the short route below) showed it: without its
// exponentials, without its cross-lane sums or without its barriers it ran
// within 10% of its own time. So the long route splits time as well.
//
// Two kernels; the wrapper (../mamba_scan.py, plan) picks one per call.
//
// mamba_scan_chunked_kernel, for sequences of SCAN_MIN_SEQ steps and more:
//   * time across lanes: a block walks S in chunks of kChunk = 128 steps;
//     inside a chunk a channel's steps are split over P = kChunk / K = 8
//     lanes of one warp, each holding K = kStepsPerLane = 16 consecutive
//     steps. For each state n in turn a lane computes its K decays
//     exp2(dt * A log2 e) and inputs dt x B, folds them into one (decay,
//     input) pair (the decay as exp2 of its summed dt), combines the pairs
//     over its P lanes by an inclusive shuffle scan (the operator of
//     repro/models/ssm.py _ssm_combine), the first lane having joined the
//     state the chunk starts from, then runs its K steps again from the
//     state its left neighbour ends with, adding C_t[n] h_t into K
//     accumulators of y in registers. Each exponential is evaluated once;
//     nothing of y crosses lanes and no barrier is needed inside a chunk.
//     A block's 8 warps hold 32 channels, so B 1, D 8192 makes 256
//     blocks, two an SM (the occupancy calculator's count): 16 warps an SM
//     where the short route has 8;
//   * a ring of two stages in shared memory: one thread issues the x and
//     dt tiles [kChunk][32 channels] by TMA (3-D tensor maps over the
//     strided [B,S,D] views, zeros past S and D), in their own dtype,
//     counted in bytes on the stage's `full` mbarrier, two chunks ahead;
//     B and C go in by cp.async, 4 bytes a thread at a time, transposed,
//     [n][t], as float32 with four words of padding every 32 steps, so
//     that a lane's 16-byte reads of four steps of one state are free of
//     bank conflicts; they land while the previous chunk is computed on.
//     There is no producer warp: a ninth warp cut ptxas to 96 registers
//     for two blocks an SM, with spills, and the kernel ran 1.12x slower
//     (PERF.md); with eight warps it has 128;
//   * y leaves through shared memory, [kChunk, 32] at a time in two
//     alternating buffers (a lane's K rows 16 bytes further apart than
//     their size, so the lanes of a channel write to different banks):
//     one barrier a chunk, which also hands the stages on (the next
//     chunk's B and C are in; this chunk's x and dt tiles are free for the
//     TMA of the chunk after next), then coalesced 16-byte stores; D x
//     starts each step's sum; the first lane of each channel keeps the
//     state carried from chunk to chunk and writes the final h;
//   * sums run in a fixed order (no atomics): results are bitwise
//     repeatable. The scan composes decays in another order than the
//     sequential recurrence, so y agrees with it to float32 rounding; a
//     lane's product of decays below 2^-126 becomes zero, dropping a share
//     of the state below 2^-126 of it, as the sequential order does step by
//     step;
//   * what holds it now (measured on the card, PERF.md): latency. Four
//     warps share a scheduler, and each state's step of a lane is a chain
//     (the exponentials, the fold, three shuffle rounds, the second pass)
//     that they cannot cover; removing any one part (the exponentials, the
//     scan, the second pass, the bank conflicts of the x and dt reads,
//     which all lanes of a channel make in one column) gained 4-18% each,
//     none of them all of it, and a second state in flight spills;
//   * TMA needs 16-byte aligned rows: D a multiple of 8 and x, dt strides
//     and starts to match; the wrapper sends other calls to the short
//     route.
//
// mamba_scan_kernel, the short route (sequences shorter than one chunk:
// the router's 16-token forwards; and any call the long route does not
// take): the state is spread, each thread holding R = min(N, 4) states of
// one channel and L = N / R neighbouring lanes sharing a channel; a block
// of 128 threads owns 128 / L channels of one batch row and walks S in
// chunks of up to 32 steps; x, dt ([T, CH] tiles) and B, C ([T, N]) come
// in coalesced, one chunk ahead into registers, are converted to float32
// into shared memory; after the chunk's steps the L partial sums of each
// (step, channel) are added and y leaves coalesced. At 16 steps it is
// three times as fast as the chunked kernel, whose lanes would hold
// nothing to split.
//
// Both routes: exp(dt * A) is 2^(dt * (A * log2 e)) by one ex2.approx.ftz
// (relative error ~2^-22), A * log2 e folded in once a state; float32
// throughout; nothing is padded in device memory: ragged S and D are masked
// in the kernels, and x, dt, B and C are read through their batch and
// sequence strides (the last dimension contiguous).
//
// Plain C interface, loaded with ctypes (see ../mamba_scan.py):
//   int coserve_mamba_scan(x, dt, b, c, a, d, y, h, B, S, D, N,
//                          x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss,
//                          x_bf16, dt_bf16, bc_bf16, stream)
//     the short route; coserve_mamba_scan_chunked takes the same arguments
//     and launches the long route. Strides in elements; y [B,S,D] and h
//     [B,D,N] contiguous; a, d float32 contiguous; N a power of two up to
//     32; dt and b/c each float32 or x's dtype; returns a cudaError_t, 0
//     when the launch was accepted.
//   int coserve_mamba_scan_chunked_occupancy(N, x_bf16, dt_bf16, bc_bf16)
//     blocks of the chunked kernel an SM holds, or -1.
#include <cuda.h>
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

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of copies to complete on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival; it releases the thread's earlier shared-memory accesses to
// whoever waits on the phase.
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

// ------------------------------------------------------------------------ //
// long route: chunks of kChunk steps, time across lanes
// ------------------------------------------------------------------------ //

constexpr int kChunk = 128;        // steps a block takes at a time
constexpr int kStepsPerLane = 16;  // K: consecutive steps a lane holds
constexpr int kLanesPerChannel = kChunk / kStepsPerLane;           // P
constexpr int kWarps = 8;
constexpr int kChannels = kWarps * 32 / kLanesPerChannel;  // CH
constexpr int kStages = 2;
constexpr int kChunkedThreads = kWarps * 32;
constexpr int kMinBlocks = 2;  // blocks an SM (ptxas: 128 registers)
// floats a row of the transposed B and C tiles: bc_index's padding, then
// 4 more so that the transposed stores spread over the banks
constexpr int kBcStride = kChunk + kChunk / 8 + 4;
static_assert(32 % kLanesPerChannel == 0 && kStepsPerLane % 4 == 0,
              "a channel's lanes lie in one warp; 16-byte B/C reads");

// Where step t of a chunk sits in a row of the transposed B/C tiles: four
// words of padding every 32 steps put the 16-byte reads of the 8 lanes of
// a quarter warp (steps K l .. K l + 3) on 8 different bank groups.
__device__ __forceinline__ int bc_index(int t) { return t + 4 * (t / 32); }

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <typename TX, typename TDT, int N>
struct ChunkLayout {
  // x and dt land as TMA boxes [kChunk][kChannels]
  static constexpr size_t x_bytes = (size_t)kChunk * kChannels * sizeof(TX);
  static constexpr size_t dt_bytes = (size_t)kChunk * kChannels * sizeof(TDT);
  static constexpr size_t bc_bytes = (size_t)N * kBcStride * sizeof(float);
  static constexpr size_t stage_bytes =
      align128(x_bytes + dt_bytes + 2 * bc_bytes);
  // y leaves in groups of a lane's K rows, 16 bytes more than their size
  // apart, so that the P lanes of a channel write to different banks
  static constexpr int YG = kStepsPerLane * kChannels + 16 / sizeof(TX);
  static constexpr size_t y_bytes = kLanesPerChannel * YG * sizeof(TX);
  static constexpr size_t y_offset = kStages * stage_bytes;  // 2 y buffers
  static constexpr int AS = N + 1;  // floats a channel's row of A or h
  static constexpr size_t small_offset = y_offset + 2 * y_bytes;
  static constexpr size_t bars_offset = align128(
      small_offset + (2 * kChannels * AS + kChannels) * sizeof(float));
  static constexpr size_t total = bars_offset + kStages * 8;
};

// One [kChunk][kChannels] box of a 3-D tensor map (channels, steps, batch)
// into shared memory; completion is counted in bytes on `bar`. Elements
// outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// 4 bytes from global to shared memory, asynchronously (zeros when
// `valid` is false).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// A chunk's B and C into a stage, transposed as float32, zeros past S:
// float32 inputs by cp.async (they land while the block computes), bf16
// ones loaded and converted here.
template <typename TBC, int N>
__device__ __forceinline__ void load_bc(const Args& p, float* sb, int bi,
                                        int t0) {
  constexpr int kPerThread = kChunk * N / kChunkedThreads;
  const TBC* bm = static_cast<const TBC*>(p.b) + bi * p.b_sb;
  const TBC* cm = static_cast<const TBC*>(p.c) + bi * p.c_sb;
  float* sc = sb + N * kBcStride;
  const int rows = min(kChunk, p.S - t0);
#pragma unroll
  for (int j = 0; j < (kPerThread > 0 ? kPerThread : 1); ++j) {
    const int e = j * kChunkedThreads + threadIdx.x;
    if (e >= kChunk * N) break;
    const int t = e / N, n = e % N;
    const bool valid = t < rows;
    const long long tt = valid ? t0 + t : 0;
    if constexpr (sizeof(TBC) == 4) {
      cp_async4(sb + n * kBcStride + bc_index(t), bm + tt * p.b_ss + n,
                valid);
      cp_async4(sc + n * kBcStride + bc_index(t), cm + tt * p.c_ss + n,
                valid);
    } else {
      sb[n * kBcStride + bc_index(t)] =
          valid ? to_float(bm[tt * p.b_ss + n]) : 0.f;
      sc[n * kBcStride + bc_index(t)] =
          valid ? to_float(cm[tt * p.c_ss + n]) : 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One thread issues a chunk's x and dt boxes into a stage.
template <typename TX, typename TDT, int N>
__device__ __forceinline__ void load_xdt(unsigned char* stage,
                                         const CUtensorMap* map_x,
                                         const CUtensorMap* map_dt,
                                         uint64_t* full, int d0, int t0,
                                         int bi) {
  using L = ChunkLayout<TX, TDT, N>;
  mbar_expect_tx(full, L::x_bytes + L::dt_bytes);
  tma_load(stage, map_x, full, d0, t0, bi);
  tma_load(stage + L::x_bytes, map_dt, full, d0, t0, bi);
}

template <typename TX, typename TDT, typename TBC, int N>
__global__ void __launch_bounds__(kChunkedThreads, kMinBlocks)
    mamba_scan_chunked_kernel(const __grid_constant__ CUtensorMap map_x,
                              const __grid_constant__ CUtensorMap map_dt,
                              Args p) {
  using L = ChunkLayout<TX, TDT, N>;
  constexpr int K = kStepsPerLane, P = kLanesPerChannel, CH = kChannels;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem + L::small_offset);
  float* s_h = s_a + CH * L::AS;
  float* s_d = s_h + CH * L::AS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars_offset);
  const int n_chunks = (p.S + kChunk - 1) / kChunk;
  auto bc_of = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::stage_bytes + L::x_bytes +
                                    L::dt_bytes);
  };

  const int bi = blockIdx.y, d0 = blockIdx.x * CH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = threadIdx.x; e < CH * N; e += kChunkedThreads) {
    const int c = e / N, n = e % N;
    s_a[c * L::AS + n] =
        d0 + c < p.D ? p.a[static_cast<long long>(d0 + c) * N + n] * kLog2e
                     : 0.f;
  }
  for (int c = threadIdx.x; c < CH; c += kChunkedThreads)
    s_d[c] = d0 + c < p.D ? p.d[d0 + c] : 0.f;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < kStages && st < n_chunks; ++st)
      load_xdt<TX, TDT, N>(smem + st * L::stage_bytes, &map_x, &map_dt,
                           &full[st], d0, st * kChunk, bi);
  }
  load_bc<TBC, N>(p, bc_of(0), bi, 0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // lane l of segment `seg` holds steps [K l, K l + K) of channel `ch` in
  // every chunk
  const int seg = lane / P, l = lane % P;
  const int ch = warp * (32 / P) + seg;
  const float* a_row = s_a + ch * L::AS;
  float* h_row = s_h + ch * L::AS;  // the carried state, the first lane's
  const float dskip = s_d[ch];
  if (l == 0)
    for (int n = 0; n < N; ++n) h_row[n] = 0.f;
  TX* y = static_cast<TX*>(p.y) + static_cast<long long>(bi) * p.S * p.D +
          d0;
  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % kStages;
    const unsigned char* stage = smem + st * L::stage_bytes;
    const TX* sx = reinterpret_cast<const TX*>(stage);
    const TDT* sdt = reinterpret_cast<const TDT*>(stage + L::x_bytes);
    const float* sb =
        reinterpret_cast<const float*>(stage + L::x_bytes + L::dt_bytes);
    const float* sc = sb + N * kBcStride;
    const int t0 = i * kChunk;
    mbar_wait(&full[st], (i / kStages) & 1);

    // the lane's steps (zeros past S and D: a step past S is the
    // identity, so the state the last lane hands on is the state after
    // step S - 1)
    float dtv[K], dtx[K], acc[K], dsum = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float xv = to_float(sx[(l * K + k) * CH + ch]);
      const float dv = to_float(sdt[(l * K + k) * CH + ch]);
      dtv[k] = dv;
      dtx[k] = dv * xv;
      acc[k] = dskip * xv;
      dsum += dv;
    }
    // the next chunk's B and C land in the other stage during this one
    if (i + 1 < n_chunks) load_bc<TBC, N>(p, bc_of(st ^ 1), bi, t0 + kChunk);
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
      const float a2 = a_row[n];
      const float* brow = sb + n * kBcStride;
      float dec[K], u[K];
#pragma unroll
      for (int j = 0; j < K / 4; ++j) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(brow + bc_index(l * K + 4 * j));
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          dec[4 * j + r] = fast_exp2(dtv[4 * j + r] * a2);
          u[4 * j + r] = dtx[4 * j + r] * bv[r];
        }
      }
      // the lane's K steps as one pair: h_out = a h_in + v
      float v = u[0];
#pragma unroll
      for (int k = 1; k < K; ++k) v = fmaf(dec[k], v, u[k]);
      float a = fast_exp2(dsum * a2);
      const float h_in = l == 0 ? h_row[n] : 0.f;
      v = fmaf(a, h_in, v);
      // inclusive scan over the channel's P lanes: afterwards v is the
      // state after the lane's last step
#pragma unroll
      for (int off = 1; off < P; off *= 2) {
        const float a_prev = __shfl_up_sync(0xffffffffu, a, off, P);
        const float v_prev = __shfl_up_sync(0xffffffffu, v, off, P);
        if (l >= off) {
          v = fmaf(a, v_prev, v);
          a *= a_prev;
        }
      }
      float h = __shfl_up_sync(0xffffffffu, v, 1, P);
      const float carry = __shfl_sync(0xffffffffu, v, P - 1, P);
      if (l == 0) {
        h = h_in;
        // an asm store, which the compiler does not take to alias the
        // next state's loads, so that it may start them early
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(smem_addr(h_row + n)),
                     "f"(carry));
      }
      const float* crow = sc + n * kBcStride;
#pragma unroll
      for (int j = 0; j < K / 4; ++j) {
        const float4 c4 =
            *reinterpret_cast<const float4*>(crow + bc_index(l * K + 4 * j));
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          h = fmaf(dec[4 * j + r], h, u[4 * j + r]);
          acc[4 * j + r] = fmaf(cv[r], h, acc[4 * j + r]);
        }
      }
    }

    // y of the chunk through one of two buffers in x's layout: a barrier
    // among the consumer warps, then 16-byte stores along the channels
    TX* yb = reinterpret_cast<TX*>(smem + L::y_offset + (i & 1) * L::y_bytes);
#pragma unroll
    for (int k = 0; k < K; ++k)
      yb[l * L::YG + k * CH + ch] = from_float<TX>(acc[k]);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kChunkedThreads) : "memory");
    // every thread is past this chunk's reads of the stage's x and dt
    if (threadIdx.x == 0 && i + kStages < n_chunks)
      load_xdt<TX, TDT, N>(smem + st * L::stage_bytes, &map_x, &map_dt,
                           &full[st], d0, t0 + kStages * kChunk, bi);
    constexpr int kVec = 16 / sizeof(TX), kRowVecs = CH / kVec;
    const int rows = min(kChunk, p.S - t0);
    for (int e = threadIdx.x; e < kChunk * kRowVecs;
         e += kChunkedThreads) {
      const int t = e / kRowVecs, col = (e % kRowVecs) * kVec;
      if (t < rows && d0 + col < p.D)
        *reinterpret_cast<uint4*>(y + static_cast<long long>(t0 + t) * p.D +
                                  col) =
            *reinterpret_cast<const uint4*>(yb + (t / K) * L::YG +
                                            (t % K) * CH + col);
    }
  }

  __syncwarp();
  if (d0 + ch < p.D) {
    for (int n = l; n < N; n += P)
      p.h[(static_cast<long long>(bi) * p.D + d0 + ch) * N + n] = h_row[n];
  }
}

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

// A [batch][seq][dim] tensor with element strides (s_seq, s_batch), as
// dims (dim, seq, batch) in boxes of [kChunk][kChannels]. The stride of a
// batch of one is never used; it is set to a valid one.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* base, int dim, int seq,
                     int batch, long long s_seq, long long s_batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (batch == 1) s_batch = s_seq * seq;
  const cuuint64_t dims[3] = {(cuuint64_t)dim, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(s_seq * sizeof(T)),
                                 (cuuint64_t)(s_batch * sizeof(T))};
  const cuuint32_t box[3] = {(cuuint32_t)kChannels, (cuuint32_t)kChunk, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The dynamic shared memory the kernel asks for, and the whole of the SM's
// shared memory as the carveout, so that kMinBlocks blocks fit (left to
// itself the driver may carve out less and hold one block an SM). Called
// once per instantiation, so that a launch does nothing but launch (it can
// then be captured in a CUDA graph).
template <typename TX, typename TDT, typename TBC, int N>
cudaError_t set_attributes() {
  const auto kernel = mamba_scan_chunked_kernel<TX, TDT, TBC, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ChunkLayout<TX, TDT, N>::total);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

// Blocks of the chunked kernel an SM holds, by the occupancy calculator.
template <typename TX, typename TDT, typename TBC, int N>
cudaError_t occupancy(int* blocks) {
  static const cudaError_t attr = set_attributes<TX, TDT, TBC, N>();
  if (attr != cudaSuccess) return attr;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mamba_scan_chunked_kernel<TX, TDT, TBC, N>, kChunkedThreads,
      ChunkLayout<TX, TDT, N>::total);
}

template <typename TX, typename TDT, typename TBC, int N>
cudaError_t launch_chunked(const Args& p, int batch, cudaStream_t stream) {
  using L = ChunkLayout<TX, TDT, N>;
  // the maps are kernel parameters, copied at launch (and into a graph)
  CUtensorMap map_x, map_dt;
  cudaError_t err = make_map<TX>(&map_x, p.x, p.D, p.S, batch, p.x_ss,
                                 p.x_sb);
  if (err == cudaSuccess)
    err = make_map<TDT>(&map_dt, p.dt, p.D, p.S, batch, p.dt_ss, p.dt_sb);
  if (err != cudaSuccess) return err;
  static const cudaError_t attr = set_attributes<TX, TDT, TBC, N>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.D + kChannels - 1) / kChannels, batch);
  mamba_scan_chunked_kernel<TX, TDT, TBC, N>
      <<<grid, kChunkedThreads, L::total, stream>>>(map_x, map_dt, p);
  return cudaGetLastError();
}

template <typename TX, typename TDT, typename TBC, int N>
cudaError_t launch_route(const Args& p, int batch, bool chunked,
                         cudaStream_t stream) {
  return chunked ? launch_chunked<TX, TDT, TBC, N>(p, batch, stream)
                 : launch<TX, TDT, TBC, N>(p, batch, stream);
}

template <typename TX, typename TDT, typename TBC>
cudaError_t dispatch_n(const Args& p, int batch, int n, bool chunked,
                       cudaStream_t stream) {
  switch (n) {
    case 1: return launch_route<TX, TDT, TBC, 1>(p, batch, chunked, stream);
    case 2: return launch_route<TX, TDT, TBC, 2>(p, batch, chunked, stream);
    case 4: return launch_route<TX, TDT, TBC, 4>(p, batch, chunked, stream);
    case 8: return launch_route<TX, TDT, TBC, 8>(p, batch, chunked, stream);
    case 16: return launch_route<TX, TDT, TBC, 16>(p, batch, chunked, stream);
    case 32: return launch_route<TX, TDT, TBC, 32>(p, batch, chunked, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, long long row_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && row_bytes % 16 == 0;
}

int scan(const void* x, const void* dt, const void* b, const void* c,
         const void* a, const void* d, void* y, void* h, int batch, int seq,
         int dim, int n, long long x_sb, long long x_ss, long long dt_sb,
         long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
         long long c_ss, int x_bf16, int dt_bf16, int bc_bf16, bool chunked,
         void* stream) {
  if (batch < 1 || seq < 1 || dim < 1) return cudaErrorInvalidValue;
  if (!x_bf16 && (dt_bf16 || bc_bf16)) return cudaErrorInvalidValue;
  if (chunked) {
    // the bulk copies and y's 16-byte stores need 16-byte aligned rows
    const int xe = x_bf16 ? 2 : 4, de = dt_bf16 ? 2 : 4;
    if (dim % 8 || !aligned16(x, x_ss * xe) || !aligned16(dt, dt_ss * de) ||
        !aligned16(y, 0) ||
        (batch > 1 && (x_sb * xe % 16 || dt_sb * de % 16)))
      return cudaErrorInvalidValue;
  }
  Args p{x, dt, b, c, static_cast<const float*>(a),
         static_cast<const float*>(d), y, static_cast<float*>(h), seq, dim,
         x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (!x_bf16) return dispatch_n<float, float, float>(p, batch, n, chunked, s);
  if (dt_bf16 && bc_bf16)
    return dispatch_n<bf16, bf16, bf16>(p, batch, n, chunked, s);
  if (dt_bf16) return dispatch_n<bf16, bf16, float>(p, batch, n, chunked, s);
  if (bc_bf16) return dispatch_n<bf16, float, bf16>(p, batch, n, chunked, s);
  return dispatch_n<bf16, float, float>(p, batch, n, chunked, s);
}

}  // namespace

extern "C" int coserve_mamba_scan(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a, const void* d, void* y, void* h, int batch, int seq,
    int dim, int n, long long x_sb, long long x_ss, long long dt_sb,
    long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, int x_bf16, int dt_bf16, int bc_bf16, void* stream) {
  return scan(x, dt, b, c, a, d, y, h, batch, seq, dim, n, x_sb, x_ss, dt_sb,
              dt_ss, b_sb, b_ss, c_sb, c_ss, x_bf16, dt_bf16, bc_bf16, false,
              stream);
}

extern "C" int coserve_mamba_scan_chunked(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a, const void* d, void* y, void* h, int batch, int seq,
    int dim, int n, long long x_sb, long long x_ss, long long dt_sb,
    long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, int x_bf16, int dt_bf16, int bc_bf16, void* stream) {
  return scan(x, dt, b, c, a, d, y, h, batch, seq, dim, n, x_sb, x_ss, dt_sb,
              dt_ss, b_sb, b_ss, c_sb, c_ss, x_bf16, dt_bf16, bc_bf16, true,
              stream);
}

// Blocks an SM holds of the chunked kernel for state width n and these
// dtypes (the occupancy calculator's count), or -1 on a refused query.
extern "C" int coserve_mamba_scan_chunked_occupancy(int n, int x_bf16,
                                                    int dt_bf16,
                                                    int bc_bf16) {
  using bf16 = __nv_bfloat16;
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
#define COSERVE_OCC(NN)                                                   \
  case NN:                                                                \
    if (!x_bf16)                                                          \
      err = occupancy<float, float, float, NN>(&blocks);                  \
    else if (dt_bf16 && bc_bf16)                                          \
      err = occupancy<bf16, bf16, bf16, NN>(&blocks);                     \
    else if (dt_bf16)                                                     \
      err = occupancy<bf16, bf16, float, NN>(&blocks);                    \
    else if (bc_bf16)                                                     \
      err = occupancy<bf16, float, bf16, NN>(&blocks);                    \
    else                                                                  \
      err = occupancy<bf16, float, float, NN>(&blocks);                   \
    break;
  switch (n) {
    COSERVE_OCC(1)
    COSERVE_OCC(2)
    COSERVE_OCC(4)
    COSERVE_OCC(8)
    COSERVE_OCC(16)
    COSERVE_OCC(32)
    default:
      break;
  }
#undef COSERVE_OCC
  return err == cudaSuccess ? blocks : -1;
}

extern "C" const char* coserve_mamba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
