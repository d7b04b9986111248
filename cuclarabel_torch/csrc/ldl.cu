// Batched dense LDL^T KKT engine for NVIDIA Hopper (sm_90a), in f64.
//
// Four kernels carry the dense KKT path of cuclarabel_torch
// (kkt/dense.py): a pivot-free LDL^T factorisation of the statically
// regularised quasidefinite K, its substitution, the residual
// r = b - K x, and a fused refined solve.  Every operand is batch-first
// and row-major: K and L are (B, N, N), D^-1 is (B, N), right-hand sides
// are (B, N, R) with R in {1, 2}.  N <= 128.  One thread block solves one
// problem; the B problems are independent blocks.
//
// They replace the double-float Pallas kernels of
// cuclarabel_tpu/kkt/pallas_dd.py.  Those carried f64 accuracy as
// (hi, lo) f32 pairs in a lane-major (N, N, B) layout because the TPU's
// vector unit has no f64; the H100 has native f64, so these kernels
// compute in plain double.  The function of each kernel is that of its
// TPU counterpart; the rounding differs (f64 in place of double-float,
// and another summation order).
//
// Bounds on an H100 SXM (3.35 TB/s HBM3, 34 TFLOP/s f64 outside the
// tensor cores) at the main path's shape (N = 76, B = 4096): each kernel
// moves O(N^2) bytes per problem and does O(N^2) (substitution,
// residual) or O(N^3 / 3) (factor) f64 operations, so all four are
// memory-bound; see the note above each kernel.  The chain of N pivot
// steps inside one problem is sequential, which is why one block works
// through it in shared memory with one __syncthreads() per step, and the
// card is filled by running many problems (blocks) at once.
//
// The factor and substitution bodies live in ldl_core.cuh, shared with
// the f32 kernels of ldl_f32.cu.
//
// Host interface: plain C functions returning cudaGetLastError() after
// the launch, called from kkt/ldl.py through ctypes.  No kernel
// allocates or synchronises; all launch on the caller's stream.

#include "ldl_core.cuh"

namespace {

constexpr int kFactorThreads = 256;
constexpr int kSolveThreads = 128;
constexpr int kSolveWarps = kSolveThreads / 32;
constexpr int kMaxR = 2;

// max that propagates NaN, like torch.amax and jnp.max: a NaN residual
// must never look small to the refinement acceptance test.
__device__ inline double nanmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}

__device__ inline double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Element (i, k) of a row-major matrix in device memory.
struct FullRows {
  const double* p;
  int n;
  __device__ double operator()(int i, int k) const {
    return p[(size_t)i * n + k];
  }
};

// Element (i, k) of a symmetric matrix held as its packed lower triangle.
struct PackedSym {
  const double* s;
  __device__ double operator()(int i, int k) const {
    return i >= k ? s[tri(i) + k] : s[tri(k) + i];
  }
};

// r = b - K x for R right-hand sides, one warp per row of K, lanes over
// the row's columns and a shuffle reduction.  x is in shared memory;
// b and r may be in shared or device memory.  The caller syncs after.
template <int R, class KView>
__device__ void residual_rows(KView kv, const double* x, const double* b,
                              double* r, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < n; i += nw) {
    double acc[R];
#pragma unroll
    for (int t = 0; t < R; ++t) acc[t] = 0.0;
    for (int k = lane; k < n; k += 32) {
      const double kik = kv(i, k);
#pragma unroll
      for (int t = 0; t < R; ++t) acc[t] += kik * x[k * R + t];
    }
#pragma unroll
    for (int t = 0; t < R; ++t) acc[t] = warp_sum(acc[t]);
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < R; ++t) r[i * R + t] = b[i * R + t] - acc[t];
    }
  }
}

// out[t] = max_i |v[i, t]| over the block (NaN-propagating).  red holds
// one slot per warp and right-hand side.  Returns synced.
template <int R>
__device__ void block_absmax(const double* v, int n, double* red,
                             double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  double m[R];
#pragma unroll
  for (int t = 0; t < R; ++t) m[t] = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int t = 0; t < R; ++t) m[t] = nanmax(m[t], fabs(v[i * R + t]));
  }
#pragma unroll
  for (int t = 0; t < R; ++t) m[t] = warp_max(m[t]);
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < R; ++t) red[warp * R + t] = m[t];
  }
  __syncthreads();
  if (threadIdx.x < R) {
    double a = red[threadIdx.x];
    for (int w = 1; w < nw; ++w) a = nanmax(a, red[w * R + threadIdx.x]);
    out[threadIdx.x] = a;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------
// ldl_factor: K + diag(reg) = (I + L) D (I + L)^T, no pivoting.
//
// Replaces cuclarabel_tpu/kkt/pallas_dd.py::_factor_impl, whose bodies
// are _ldl_kernel_psc2 (the default, N <= 96) and _ldl_kernel_looped
// (96 < N <= 128); its other bodies compute the same function under
// other TPU schedules.  The JAX kernels eliminate pivot pairs; this one
// eliminates one pivot per step, so the rounding differs and the factor
// is the same.
//
// Bound: reads K's lower triangle and reg, writes L's strict lower
// triangle, D^-1 and ok: about 0.19 GB at (76, 4096), 0.058 ms at
// 3.35 TB/s, against 0.6 GFLOP (18 us at 34 TFLOP/s): memory-bound.
// The kernel writes L whole, zeros included (0.29 GB in all), so the
// (B, N, N) tensor holds no junk above the diagonal; no consumer reads
// those zeros.
// Design: the packed lower triangle of one problem (23 KB at N = 76,
// 66 KB at N = 128) stays in shared memory for the whole elimination,
// so K is read once and L written once, both coalesced by rows; the
// small footprint lets several problems share an SM.  Each pivot step
// scales the pivot column, then applies the rank-1 update to the
// trailing lower triangle with one warp per row.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kFactorThreads)
    ldl_factor_kernel(const double* __restrict__ K,
                      const double* __restrict__ reg, double* __restrict__ L,
                      double* __restrict__ Dinv, unsigned char* __restrict__ ok,
                      int n) {
  extern __shared__ double smem[];
  double* a = smem;              // packed lower triangle, tri(n)
  double* acol = a + tri(n);     // pivot column before scaling, n
  double* lcol = acol + n;       // pivot column of L, n
  const size_t b = blockIdx.x;

  load_lower_packed(K + b * n * n, a, n);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    a[tri(i) + i] += reg[b * n + i];
  __syncthreads();
  const bool finite = factor_packed(a, acol, lcol, Dinv + b * n, n);
  store_strict_lower(a, L + b * n * n, n);
  if (threadIdx.x == 0) ok[b] = finite ? 1 : 0;
}

// ---------------------------------------------------------------------
// ldl_solve: x = ((I + L) D (I + L)^T)^-1 b.
//
// Replaces pallas_dd.py::_solve_impl (bodies _solve_kernel_blocked_ps,
// the default, _solve_kernel_looped, _solve_kernel and
// _solve_kernel_blocked) for R = 1 and pallas_dd.py::_solve_impl_r
// (_solve_kernel_r_blocked, _solve_kernel_r_looped, _solve_kernel_r)
// for R = 2.
//
// Bound: reads L's strict lower triangle once, about 0.095 GB at
// (76, 4096): 0.028 ms; 2 N^2 R operations per problem are negligible.
// Design: L is staged in shared memory by coalesced row reads, then the
// 2N sequential steps of the substitution run out of shared memory with
// one thread per row and one __syncthreads() per step.
// ---------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(kSolveThreads)
    ldl_solve_kernel(const double* __restrict__ L,
                     const double* __restrict__ Dinv,
                     const double* __restrict__ bg, double* __restrict__ xg,
                     int n) {
  extern __shared__ double smem[];
  double* ls = smem;            // tri(n)
  double* dinv = ls + tri(n);   // n
  double* x = dinv + n;         // n * R
  const size_t b = blockIdx.x;

  load_lower_packed(L + b * n * n, ls, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dinv[i] = Dinv[b * n + i];
#pragma unroll
    for (int t = 0; t < R; ++t) x[i * R + t] = bg[(b * n + i) * R + t];
  }
  __syncthreads();
  ldl_solve_smem<double, R>(ls, dinv, x, n);
  for (int i = threadIdx.x; i < n * R; i += blockDim.x)
    xg[b * n * R + i] = x[i];
}

// ---------------------------------------------------------------------
// kkt_residual: r = b - K x for a full (B, N, N) K.
//
// Replaces pallas_dd.py::_residual_impl (bodies _residual_kernel_c, the
// default, and _residual_kernel).  Those contract over K's leading axis,
// which equals K x only for symmetric K; this kernel contracts over
// rows, so it is right for any full K and equals them on the symmetric
// KKT matrices.
//
// Bound: the function needs one triangle of the symmetric K, about
// 0.10 GB at (76, 4096): 0.031 ms.  This kernel reads K whole (0.19 GB,
// 0.057 ms), since it assumes no more than a full K.
// Design: one warp per row of K, lanes over consecutive columns
// (coalesced), x staged in shared memory, a shuffle reduction per row.
// ---------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(kSolveThreads)
    kkt_residual_kernel(const double* __restrict__ K,
                        const double* __restrict__ xg,
                        const double* __restrict__ bg, double* __restrict__ rg,
                        int n) {
  __shared__ double x[kMaxN * kMaxR];
  const size_t b = blockIdx.x;
  for (int i = threadIdx.x; i < n * R; i += blockDim.x)
    x[i] = xg[b * n * R + i];
  __syncthreads();
  residual_rows<R>(FullRows{K + b * n * n, n}, x, bg + b * n * R,
                   rg + b * n * R, n);
}

// ---------------------------------------------------------------------
// ldl_solve_refine: x = solve(b), then npass passes of
// x' = x + solve(b - K x), each accepted per right-hand side only where
// max|b - K x'| < max|b - K x| strictly.  Returns the accepted x and its
// own residual r = b - K x.  K must be symmetric; its lower triangle is
// read.
//
// Replaces pallas_dd.py::_refine_impl (bodies _refine_kernel_c, the
// default, and _refine_kernel) for R = 1 and pallas_dd.py::_refine_impl_r
// (_refine_kernel_r) for R = 2, with their acceptance rule.
//
// Bound: reads the lower triangles of K and L once, about 0.19 GB at
// (76, 4096): 0.057 ms; the (1 + npass) solves and residuals are
// O(N^2 R) operations per problem.
// Design: both triangles stay in shared memory (47 KB at N = 76,
// 132 KB at N = 128) for every pass, so the passes read device memory
// once; the substitution and residual are the routines of ldl_solve and
// kkt_residual.
// ---------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(kSolveThreads)
    ldl_solve_refine_kernel(const double* __restrict__ K,
                            const double* __restrict__ L,
                            const double* __restrict__ Dinv,
                            const double* __restrict__ bg,
                            double* __restrict__ xg, double* __restrict__ rg,
                            int n, int npass) {
  extern __shared__ double smem[];
  double* ks = smem;             // tri(n)
  double* ls = ks + tri(n);      // tri(n)
  double* dinv = ls + tri(n);    // n
  double* bs = dinv + n;         // n * R
  double* x = bs + n * R;        // n * R, accepted iterate
  double* r = x + n * R;         // n * R, its residual
  double* xn = r + n * R;        // n * R, candidate iterate
  double* en = xn + n * R;       // n * R, its residual
  __shared__ double red[kSolveWarps * kMaxR];
  __shared__ double ne[kMaxR], nen[kMaxR];
  const size_t b = blockIdx.x;

  load_lower_packed(K + b * n * n, ks, n);
  load_lower_packed(L + b * n * n, ls, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dinv[i] = Dinv[b * n + i];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const double v = bg[(b * n + i) * R + t];
      bs[i * R + t] = v;
      x[i * R + t] = v;
    }
  }
  __syncthreads();
  ldl_solve_smem<double, R>(ls, dinv, x, n);
  residual_rows<R>(PackedSym{ks}, x, bs, r, n);
  __syncthreads();
  block_absmax<R>(r, n, red, ne);

  for (int p = 0; p < npass; ++p) {
    for (int i = threadIdx.x; i < n * R; i += blockDim.x) xn[i] = r[i];
    __syncthreads();
    ldl_solve_smem<double, R>(ls, dinv, xn, n);
    for (int i = threadIdx.x; i < n * R; i += blockDim.x) xn[i] += x[i];
    __syncthreads();
    residual_rows<R>(PackedSym{ks}, xn, bs, en, n);
    __syncthreads();
    block_absmax<R>(en, n, red, nen);
    for (int i = threadIdx.x; i < n * R; i += blockDim.x) {
      const int t = i % R;
      if (nen[t] < ne[t]) {
        x[i] = xn[i];
        r[i] = en[i];
      }
    }
    __syncthreads();
    if (threadIdx.x < R && nen[threadIdx.x] < ne[threadIdx.x])
      ne[threadIdx.x] = nen[threadIdx.x];
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n * R; i += blockDim.x) {
    xg[b * n * R + i] = x[i];
    rg[b * n * R + i] = r[i];
  }
}

size_t factor_smem(int n) { return sizeof(double) * (tri(n) + 2 * n); }
size_t solve_smem(int n, int r) {
  return sizeof(double) * (tri(n) + n + n * r);
}
size_t refine_smem(int n, int r) {
  return sizeof(double) * (2 * tri(n) + n + 5 * n * r);
}

// Raise a kernel's dynamic shared memory cap to what N = kMaxN needs,
// once per kernel and device: the attribute belongs to the current
// device's context, and above 48 KB a launch needs it.
constexpr int kMaxDevices = 64;
using DeviceFlags = bool[kMaxDevices];

template <class F>
cudaError_t allow_smem(F* kernel, size_t bytes, DeviceFlags& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && known) done[dev] = true;
  return e;
}

bool bad_shape(int B, int n, int r) {
  return B < 0 || n < 1 || n > kMaxN || r < 1 || r > kMaxR;
}

}  // namespace

extern "C" {

int cc_ldl_factor(const double* K, const double* reg, double* L,
                  double* Dinv, unsigned char* ok, int B, int n,
                  void* stream) {
  if (bad_shape(B, n, 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  static DeviceFlags attr = {};
  cudaError_t e = allow_smem(ldl_factor_kernel, factor_smem(kMaxN), attr);
  if (e != cudaSuccess) return (int)e;
  ldl_factor_kernel<<<B, kFactorThreads, factor_smem(n),
                      (cudaStream_t)stream>>>(K, reg, L, Dinv, ok, n);
  return (int)cudaGetLastError();
}

int cc_ldl_solve(const double* L, const double* Dinv, const double* b,
                 double* x, int B, int n, int r, void* stream) {
  if (bad_shape(B, n, r)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  static DeviceFlags attr1 = {}, attr2 = {};
  cudaError_t e;
  if (r == 1) {
    e = allow_smem(ldl_solve_kernel<1>, solve_smem(kMaxN, 1), attr1);
    if (e != cudaSuccess) return (int)e;
    ldl_solve_kernel<1><<<B, kSolveThreads, solve_smem(n, 1),
                          (cudaStream_t)stream>>>(L, Dinv, b, x, n);
  } else {
    e = allow_smem(ldl_solve_kernel<2>, solve_smem(kMaxN, 2), attr2);
    if (e != cudaSuccess) return (int)e;
    ldl_solve_kernel<2><<<B, kSolveThreads, solve_smem(n, 2),
                          (cudaStream_t)stream>>>(L, Dinv, b, x, n);
  }
  return (int)cudaGetLastError();
}

int cc_kkt_residual(const double* K, const double* x, const double* b,
                    double* res, int B, int n, int r, void* stream) {
  if (bad_shape(B, n, r)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (r == 1)
    kkt_residual_kernel<1><<<B, kSolveThreads, 0, (cudaStream_t)stream>>>(
        K, x, b, res, n);
  else
    kkt_residual_kernel<2><<<B, kSolveThreads, 0, (cudaStream_t)stream>>>(
        K, x, b, res, n);
  return (int)cudaGetLastError();
}

int cc_ldl_solve_refine(const double* K, const double* L, const double* Dinv,
                        const double* b, double* x, double* res, int B, int n,
                        int r, int npass, void* stream) {
  if (bad_shape(B, n, r) || npass < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  static DeviceFlags attr1 = {}, attr2 = {};
  cudaError_t e;
  if (r == 1) {
    e = allow_smem(ldl_solve_refine_kernel<1>, refine_smem(kMaxN, 1), attr1);
    if (e != cudaSuccess) return (int)e;
    ldl_solve_refine_kernel<1><<<B, kSolveThreads, refine_smem(n, 1),
                                 (cudaStream_t)stream>>>(K, L, Dinv, b, x,
                                                         res, n, npass);
  } else {
    e = allow_smem(ldl_solve_refine_kernel<2>, refine_smem(kMaxN, 2), attr2);
    if (e != cudaSuccess) return (int)e;
    ldl_solve_refine_kernel<2><<<B, kSolveThreads, refine_smem(n, 2),
                                 (cudaStream_t)stream>>>(K, L, Dinv, b, x,
                                                         res, n, npass);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
