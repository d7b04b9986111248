// Batched pivot-free LDL^T factor and solve in f32 for NVIDIA Hopper
// (sm_90a): the entry points kkt/ldl_f32.py::ldl_factor_batched and
// ldl_solve_batched.
//
// They replace the two Pallas kernels of cuclarabel_tpu/kkt/pallas_ldl.py,
// the single-float LDL^T that the JAX package keeps as the f32 baseline
// of its f64-grade engine.  The reference lays the batch across the
// TPU's 128 lanes, (N, N, B) padded to a multiple of 128, and unrolls
// the N pivot steps as (B,)-wide vector operations.  Here one thread
// block takes one problem, batch-first and row-major, K and L (B, N, N),
// D^-1 and right-hand sides (B, N), N <= 128, any B: no padding.  The
// bodies are those of the f64 kernels (ldl_core.cuh) with T = float and
// no regularisation.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3, 33.5 T f32 instructions/s
// outside the tensor cores, each multiply and each add one instruction
// under -fmad=false) at N = 76, B = 4096: the factor reads K's lower
// triangle and writes L's strict lower triangle and D^-1, about 0.096 GB
// (0.029 ms), against 0.61 G operations (0.018 ms); the solve reads L's
// strict lower triangle, D^-1 and b and writes x, about 0.050 GB (0.015
// ms), against 2 N^2 operations per problem.  Both are memory-bound, and
// the chain of N pivot (2N substitution) steps inside one problem is
// sequential, so a block keeps its problem in shared memory (20 KB at
// N = 76 for the factor, 46 KB at N = 128, under the 48 KB that needs no
// opt-in) and the card is filled with problems.
//
// Host interface: plain C functions returning cudaGetLastError() after
// the launch, called through ctypes.  No kernel allocates or
// synchronises; both launch on the caller's stream.

#include "ldl_core.cuh"

namespace {

// ---------------------------------------------------------------------
// K = (I + L) D (I + L)^T, no pivoting, no regularisation.
//
// Replaces cuclarabel_tpu/kkt/pallas_ldl.py::_factor_impl (body
// _ldl_kernel).  That kernel reads the column below each pivot, which
// is the lower triangle of K; this one reads only that triangle too, so
// both assume a symmetric K.  It writes L whole: the strict lower
// factor, zeros on and above the diagonal (the reference leaves junk
// there; no consumer reads it).  The body is the f64 ldl_factor's
// blocked factor (ldl_core.cuh::factor_blocked) with T = float and no
// regularisation, bit for bit with the plain version as that one is.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kFactorThreads)
    ldl_factor_f32_kernel(const float* __restrict__ K, float* __restrict__ L,
                          float* __restrict__ Dinv, int n) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x;
  factor_blocked<float>(K + b * n * n, nullptr, L + b * n * n,
                           Dinv + b * n, smem, n);
}

// ---------------------------------------------------------------------
// x = ((I + L) D (I + L)^T)^-1 b for one right-hand side per problem.
//
// Replaces cuclarabel_tpu/kkt/pallas_ldl.py::_solve_impl (body
// _solve_kernel).  The reference substitutes by rows (dot products);
// this kernel substitutes forward by columns and backward by rows of L
// with the f64 ldl_solve's one-warp body (ldl_core.cuh::warp_solve):
// L's strict triangle requested at once with cp.async, x in registers,
// one shuffle per step: 0.054 ms at (76, 4096) by CUDA events against
// the 0.015 ms bound on an H100 80GB HBM3 at 700 W.  The function is the same, the
// rounding differs.
// ---------------------------------------------------------------------
template <int S>
__global__ void __launch_bounds__(kLoadThreads, 1)
    ldl_solve_f32_kernel(const float* __restrict__ L,
                         const float* __restrict__ Dinv,
                         const float* __restrict__ bg, float* __restrict__ xg,
                         int n) {
  extern __shared__ float ls[];  // tri(n), packed strict lower
  const size_t b = blockIdx.x;
  load_lower_async(L + b * n * n, ls, n, false);
  cp_async_commit();
  float dinv[S], x[S][1];
  load_dinv<float>(Dinv + b * n, dinv, n);
  load_rows<float, 1>(bg + b * n, x, n);
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x >= kWarp) return;
  warp_solve<float, 1>(ls, dinv, x, n);
  store_rows<float, 1>(x, xg + b * n, n);
}

size_t factor_smem(int n) {
  return sizeof(float) * FactorLayout<float>(n).smem();
}

cudaError_t ready_factor() {
  static DeviceFlags done = {};
  return allow_smem(ldl_factor_f32_kernel, factor_smem(kMaxN), done);
}
size_t solve_smem(int n) { return sizeof(float) * tri(n); }

bool bad_shape(int B, int n) { return B < 0 || n < 1 || n > kMaxN; }

}  // namespace

extern "C" {

int cc_ldl_factor_f32(const float* K, float* L, float* Dinv, int B, int n,
                      void* stream) {
  if (bad_shape(B, n)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t e = ready_factor();
  if (e != cudaSuccess) return (int)e;
  ldl_factor_f32_kernel<<<B, kFactorThreads, factor_smem(n),
                          (cudaStream_t)stream>>>(K, L, Dinv, n);
  return (int)cudaGetLastError();
}

int cc_ldl_solve_f32(const float* L, const float* Dinv, const float* b,
                     float* x, int B, int n, void* stream) {
  if (bad_shape(B, n)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return with_slots(n, [&](auto S) {
    ldl_solve_f32_kernel<decltype(S)::value>
        <<<B, kLoadThreads, solve_smem(n), (cudaStream_t)stream>>>(
            L, Dinv, b, x, n);
    return (int)cudaGetLastError();
  });
}

// Resident blocks per SM and threads per block of ldl_factor_f32's
// launch at N = n on the current device.
int cc_occupancy_f32(int n, int* blocks, int* threads) {
  if (bad_shape(1, n)) return (int)cudaErrorInvalidValue;
  *threads = kFactorThreads;
  cudaError_t e = ready_factor();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ldl_factor_f32_kernel, kFactorThreads, factor_smem(n));
}

// The same for ldl_solve_f32's launch at N = n.
int cc_occupancy_f32_solve(int n, int* blocks, int* threads) {
  if (bad_shape(1, n)) return (int)cudaErrorInvalidValue;
  *threads = kLoadThreads;
  return with_slots(n, [&](auto S) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ldl_solve_f32_kernel<decltype(S)::value>, kLoadThreads,
        solve_smem(n));
  });
}

}  // extern "C"
