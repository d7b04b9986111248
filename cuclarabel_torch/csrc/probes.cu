// Issue-rate probes for NVIDIA Hopper (sm_90a): the entry points
// probes/mosaic_probe.py::chain (P1) and probes/mosaic_probe2.py::run
// (P2).
//
// They replace the two Pallas microbenchmarks of the JAX package's tuning
// work, scripts/mosaic_probe.py::bench and scripts/mosaic_probe2.py::make,
// which asked a TPU what one elementwise op costs on a large operand and
// where values fall out of the fastest storage.  On Hopper the questions
// become: does a streaming elementwise kernel overlap instruction issue
// with memory traffic (P1), and how many values can a thread carry
// through a dependent chain before they spill from registers, and at what
// cost (P2).  The redesign of the f64 factor with a register-blocked
// trailing update rests on both answers.
//
// One "round" is r <- r * y + y: a multiply, then an add, each rounded
// (the library is built with -fmad=false), so every kernel here equals its
// plain PyTorch version bit for bit.
//
// Host interface: plain C functions returning cudaGetLastError() after
// the launch, called through ctypes.  No kernel allocates or
// synchronises; both launch on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kChainThreads = 256;
constexpr int kLanes = 128;  // P2's operand is (R, 128): one thread a lane
constexpr int kWin = 3;      // P1 B's window is [3:, 3:, :]
constexpr int kIlpStreams = 4;
// P2 keeps a thread's values in an unrolled register array up to this R;
// above it, a runtime loop over an array in local memory
constexpr int kUnrolledMaxR = 128;

enum Variant { kChain = 0, kWindow = 1, kIlp = 2 };

// 1 + 0.5^(k+1), exact in f32: the scale of stream k
__device__ __forceinline__ float stream_scale(int k) {
  return 1.0f + 1.0f / float(2 << k);
}

// ---------------------------------------------------------------------
// P1: 48 rounds (`rounds`) over a flat (N, N, B) f32 array.
//
// Replaces scripts/mosaic_probe.py::bench (pallas_call over kern_chain,
// kern_chain_win, kern_ilp and make_chunk(rows)).  The TPU kernel walks
// (N, N, 128) lane blocks in VMEM.  Here a persistent grid strides over
// the flat array in tiles of kChainThreads * P elements: thread t carries
// the P elements t + k * kChainThreads of its tile, each a coalesced warp
// load, through the whole chain in registers.  P = 1 for A, B and C; the
// TPU's row chunk of D becomes P = 8, 16, 32 elements in flight per
// thread (D's output equals A's bit for bit; its time shows how much
// instruction-level parallelism the FP32 pipe needs).  B computes (i, j)
// from the flat index and copies x outside its window; C carries four
// chains per element.
//
// Bound on an H100 SXM at (83, 4096): x, y and o are 338.6 MB, 0.101 ms at
// 3.35 TB/s, against 0.081 ms of unfused f32 issue for A's 96 ops per
// element: the kernel sits at the ridge, and is near its bound only if
// the SM overlaps the chains of some warps with the loads of others.
// Operands are 7x the 50 MB L2, so every launch is cold.
// ---------------------------------------------------------------------
template <int V, int P>
__global__ void __launch_bounds__(kChainThreads)
    probe_chain_kernel(const float* __restrict__ x,
                       const float* __restrict__ y, float* __restrict__ o,
                       unsigned n, unsigned b, int rounds) {
  static_assert(V == kChain || P == 1, "only A carries several elements");
  const unsigned total = n * n * b;
  constexpr unsigned tile = kChainThreads * P;
  for (unsigned base = blockIdx.x * tile; base < total;
       base += gridDim.x * tile) {
    const unsigned first = base + threadIdx.x;
    if constexpr (V == kChain) {
      float r[P], yv[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const unsigned i = first + k * kChainThreads;
        r[k] = i < total ? x[i] : 0.0f;
        yv[k] = i < total ? y[i] : 0.0f;
      }
      for (int it = 0; it < rounds; ++it) {
#pragma unroll
        for (int k = 0; k < P; ++k) r[k] = r[k] * yv[k] + yv[k];
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const unsigned i = first + k * kChainThreads;
        if (i < total) o[i] = r[k];
      }
    } else if constexpr (V == kWindow) {
      if (first >= total) continue;
      float r = x[first];
      const unsigned row = first / b;  // i * n + j
      const unsigned i = row / n, j = row - i * n;
      if (i >= kWin && j >= kWin) {
        const float yv = y[first];
        for (int it = 0; it < rounds; ++it) r = r * yv + yv;
      }
      o[first] = r;
    } else {
      if (first >= total) continue;
      const float xv = x[first], yv = y[first];
      float p[kIlpStreams];
#pragma unroll
      for (int k = 0; k < kIlpStreams; ++k) p[k] = xv * stream_scale(k);
      for (int it = 0; it < rounds; ++it) {
#pragma unroll
        for (int k = 0; k < kIlpStreams; ++k) p[k] = p[k] * yv + yv;
      }
      o[first] = (p[0] + p[1]) + (p[2] + p[3]);
    }
  }
}

// ---------------------------------------------------------------------
// P2: `rounds` rounds over S independent streams of an (R, 128) f32
// operand, in one block.
//
// Replaces scripts/mosaic_probe2.py::make (pallas_call over kern), which
// runs one program on one TPU core; one block here is one SM, so the rate
// is one SM's.  Thread t owns lane t: R values of y and S x R of the
// streams, pk = x * (1 + 0.5^(k+1)), combined as ((p0 + p1) + p2) + p3.
// R is a template argument so that the values can live in registers: up
// to kUnrolledMaxR the loops over them are unrolled (2R values at one
// stream need 2R registers, so R = 128 is over the 255-per-thread cap and
// ptxas spills); above it they are a runtime loop over arrays in local
// memory (512 KB and more per block at R >= 512, over the SM's 256 KB of
// L1 and shared memory, so the values stream from L2).  The rounds loop
// is a runtime loop throughout, to keep the code inside the instruction
// cache.
//
// Bound: real_ops * R * 128 operations over one SM's 128 f32 lanes per
// clock, 2.07 us at R = 8 and 0.529 ms at R = 2048 at 1.98 GHz.
// ---------------------------------------------------------------------
template <int R, int S>
__device__ __forceinline__ void issue_round(float (&p)[S][R],
                                            const float (&yv)[R], int i) {
#pragma unroll
  for (int s = 0; s < S; ++s) p[s][i] = p[s][i] * yv[i] + yv[i];
}

template <int R, int S>
__global__ void __launch_bounds__(kLanes, 1)
    probe_issue_kernel(const float* __restrict__ x,
                       const float* __restrict__ y, float* __restrict__ o,
                       int rounds) {
  const int t = threadIdx.x;
  float yv[R], p[S][R];
  if constexpr (R <= kUnrolledMaxR) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float xv = x[i * kLanes + t];
      yv[i] = y[i * kLanes + t];
#pragma unroll
      for (int s = 0; s < S; ++s) p[s][i] = xv * stream_scale(s);
    }
    for (int it = 0; it < rounds; ++it) {
#pragma unroll
      for (int i = 0; i < R; ++i) issue_round<R, S>(p, yv, i);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float r = p[0][i];
#pragma unroll
      for (int s = 1; s < S; ++s) r = r + p[s][i];
      o[i * kLanes + t] = r;
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < R; ++i) {
      const float xv = x[i * kLanes + t];
      yv[i] = y[i * kLanes + t];
#pragma unroll
      for (int s = 0; s < S; ++s) p[s][i] = xv * stream_scale(s);
    }
    for (int it = 0; it < rounds; ++it) {
#pragma unroll 4
      for (int i = 0; i < R; ++i) issue_round<R, S>(p, yv, i);
    }
#pragma unroll 1
    for (int i = 0; i < R; ++i) {
      float r = p[0][i];
#pragma unroll
      for (int s = 1; s < S; ++s) r = r + p[s][i];
      o[i * kLanes + t] = r;
    }
  }
}

template <int V, int P>
int launch_chain(const float* x, const float* y, float* o, int n, int b,
                 int rounds, cudaStream_t stream) {
  const unsigned total = unsigned(n) * unsigned(n) * unsigned(b);
  const unsigned tiles = (total + kChainThreads * P - 1) / (kChainThreads * P);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe_chain_kernel<V, P>, kChainThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const unsigned resident = unsigned(sms) * unsigned(per_sm > 0 ? per_sm : 1);
  const unsigned grid = tiles < resident ? tiles : resident;
  probe_chain_kernel<V, P><<<grid, kChainThreads, 0, stream>>>(
      x, y, o, unsigned(n), unsigned(b), rounds);
  return (int)cudaGetLastError();
}

template <int R, int S>
int launch_issue(const float* x, const float* y, float* o, int rounds,
                 cudaStream_t stream) {
  probe_issue_kernel<R, S><<<1, kLanes, 0, stream>>>(x, y, o, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant: 0 = A or D, 1 = B, 2 = C; per_thread: 1, or 8, 16, 32 for D.
// n * n * b must stay below 2^31.
int cc_probe_chain(const float* x, const float* y, float* o, int n, int b,
                   int variant, int per_thread, int rounds, void* stream) {
  if (n < 1 || b < 1 || rounds < 0 ||
      (long long)n * n * b >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == kChain) {
    switch (per_thread) {
      case 1: return launch_chain<kChain, 1>(x, y, o, n, b, rounds, st);
      case 8: return launch_chain<kChain, 8>(x, y, o, n, b, rounds, st);
      case 16: return launch_chain<kChain, 16>(x, y, o, n, b, rounds, st);
      case 32: return launch_chain<kChain, 32>(x, y, o, n, b, rounds, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (per_thread != 1) return (int)cudaErrorInvalidValue;
  if (variant == kWindow)
    return launch_chain<kWindow, 1>(x, y, o, n, b, rounds, st);
  if (variant == kIlp) return launch_chain<kIlp, 1>(x, y, o, n, b, rounds, st);
  return (int)cudaErrorInvalidValue;
}

// The (R, streams) pairs of the reference's sweep: R = 8 ... 2048 at one
// stream, R = 8, 32, 512 at four.
int cc_probe_issue(const float* x, const float* y, float* o, int r,
                   int streams, int rounds, void* stream) {
  if (rounds < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (streams == 1) {
    switch (r) {
      case 8: return launch_issue<8, 1>(x, y, o, rounds, st);
      case 32: return launch_issue<32, 1>(x, y, o, rounds, st);
      case 128: return launch_issue<128, 1>(x, y, o, rounds, st);
      case 512: return launch_issue<512, 1>(x, y, o, rounds, st);
      case 1024: return launch_issue<1024, 1>(x, y, o, rounds, st);
      case 2048: return launch_issue<2048, 1>(x, y, o, rounds, st);
    }
  } else if (streams == kIlpStreams) {
    switch (r) {
      case 8: return launch_issue<8, 4>(x, y, o, rounds, st);
      case 32: return launch_issue<32, 4>(x, y, o, rounds, st);
      case 512: return launch_issue<512, 4>(x, y, o, rounds, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
