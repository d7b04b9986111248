// Batched dense LDL^T KKT engine for NVIDIA Hopper (sm_90a), in f64.
//
// Four kernels carry the dense KKT path of cuclarabel_torch
// (kkt/dense.py): a pivot-free LDL^T factorisation of the statically
// regularised quasidefinite K, its substitution, the residual
// r = b - K x, and a fused refined solve.  Every operand is batch-first
// and row-major: K and L are (B, N, N), D^-1 is (B, N), right-hand sides
// are (B, N, R) with R in {1, 2}.  N <= 128 (kkt/ldl.py launches the wide
// forms of ldl_wide.cu above).  One thread block solves one problem; the B
// problems are independent blocks.
//
// They replace the double-float Pallas kernels of
// cuclarabel_tpu/kkt/pallas_dd.py.  Those carried f64 accuracy as
// (hi, lo) f32 pairs in a lane-major (N, N, B) layout because the TPU's
// vector unit has no f64; the H100 has native f64, so these kernels
// compute in plain double.  The function of each kernel is that of its
// TPU counterpart; the rounding differs (f64 in place of double-float,
// and another summation order).
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 16.7 T f64 instructions/s
// outside the tensor cores, 132 SMs x 64 lanes x 1.98 GHz, each multiply
// and each add one instruction under -fmad=false) at the main path's
// shape (N = 76, B = 4096): each kernel moves O(N^2) bytes per problem
// and does O(N^2) (substitution, residual) or O(N^3 / 3) (factor) f64
// operations, so all four are memory-bound by their bytes; see the note
// above each kernel.  The chain of pivot steps inside one problem is
// sequential, so what they wait on is latency: the factor works through
// it in shared memory in panels of 8 pivots with two block barriers per
// panel, the substitution and the refined solve in one warp with one
// shuffle per step, and the card is filled by running many problems
// (blocks) at once.
//
// The factor and substitution bodies live in ldl_core.cuh, shared with
// the f32 kernels of ldl_f32.cu.
//
// Host interface: plain C functions returning cudaGetLastError() after
// the launch, called from kkt/ldl.py through ctypes.  No kernel
// allocates or synchronises; all launch on the caller's stream.

#include "ldl_core.cuh"

namespace {

constexpr int kMaxR = 2;

// max that propagates NaN, like torch.amax and jnp.max: a NaN residual
// must never look small to the refinement acceptance test.
__device__ inline double nanmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}

__device__ inline double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// r = b - K x for the symmetric K held as its packed lower triangle ks
// (row i at tri(i), diagonal included), by warps; x, b and r are the
// lane's rows (ldl_core.cuh's warp layout).  kkt_residual deals the
// groups of rows out to its warps, ldl_solve_refine runs them all in
// one warp; both sum in one order, so their residuals agree bit for bit.
//
// For row i, lane l sums K_ik x_k over its own k = l + 32 q in ascending
// q, and the 32 partial sums are added along a butterfly tree (lane l
// with lane l ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1).  K_ik is read from row i
// (k <= i, lanes on consecutive columns) or from column i of row k
// (k > i, lanes on rows tri(k) + i, conflict-free as in the forward
// sweep).
//
// Rows go in groups of kRowGroup = 8, and the first three levels of the
// tree are transposed: at level o each lane keeps the half of its rows
// picked by its bit o and trades the other half with lane l ^ o, so the
// group takes 4 + 2 + 1 shuffles there in place of 3 x 8, and each lane
// ends with one row (g = bits 4, 3, 2 of the lane), whose last two
// levels are a plain butterfly.  The pairs added are the tree's own, so
// the sums are the same.
constexpr int kRowGroup = 8;

// One transposed level: the G rows of v become G / 2, the lane keeping
// rows [0, G/2) or [G/2, G) by its bit o, summed with lane l ^ o.
template <int G, int R>
__device__ inline void transpose_level(double (&v)[kRowGroup][R], int o) {
  const bool hi = (threadIdx.x & o) != 0;
#pragma unroll
  for (int g = 0; g < G / 2; ++g) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const double keep = hi ? v[g + G / 2][t] : v[g][t];
      const double send = hi ? v[g][t] : v[g + G / 2][t];
      v[g][t] = keep + __shfl_xor_sync(kFullMask, send, o);
    }
  }
}

// tri(k) of the lane's columns k = 32 q + lane (k >= n: 0).
template <int S>
__device__ inline void column_offsets(int (&off)[S], int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int k = kWarp * q + lane;
    off[q] = k < n ? tri(k) : 0;
  }
}

// The sums of one group of rows, i = 32 p + i0 + g, g < kRowGroup, by
// the calling warp: on return lane l, i0 <= l < min(i0 + 8, rows), holds
// sum[t] = (K x)_it of row i = 32 p + l (rows = the rows of panel p).
template <int R, int S>
__device__ inline void residual_group(const double* ks,
                                      const double (&x)[S][R],
                                      const int (&off)[S], int n, int p,
                                      int i0, int rows, double (&sum)[R]) {
  const int lane = threadIdx.x & 31;
  // the lane holding row g of a group after the transposed levels
  const int g = lane & (kRowGroup - 1);
  const int src = ((g >> 2) & 1) << 4 | ((g >> 1) & 1) << 3 | (g & 1) << 2;
  double kik[kRowGroup][S];  // K_ik, i = 32 p + i0 + gg
#pragma unroll
  for (int gg = 0; gg < kRowGroup; ++gg) {
    const int i = kWarp * p + min(i0 + gg, rows - 1);
    const int ti = tri(i);
#pragma unroll
    for (int q = 0; q < S; ++q) {
      // two adds and a select, no branch (k >= n: off[q] = 0, index i)
      const int k = kWarp * q + lane;
      kik[gg][q] = ks[k <= i ? ti + k : off[q] + i];
    }
  }
  __syncwarp();  // every load of the group issued before the sums
  double v[kRowGroup][R];
#pragma unroll
  for (int gg = 0; gg < kRowGroup; ++gg) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      v[gg][t] = 0.0;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const double w = v[gg][t] + kik[gg][q] * x[q][t];
        v[gg][t] = kWarp * q + lane < n ? w : v[gg][t];
      }
    }
  }
  transpose_level<8, R>(v, 16);
  transpose_level<4, R>(v, 8);
  transpose_level<2, R>(v, 4);
#pragma unroll
  for (int t = 0; t < R; ++t) {
    double s = v[0][t];
    s += __shfl_xor_sync(kFullMask, s, 2);
    s += __shfl_xor_sync(kFullMask, s, 1);
    sum[t] = __shfl_sync(kFullMask, s, src);
  }
}

// Every group by the calling warp (ldl_solve_refine).
template <int R, int S>
__device__ void warp_residual(const double* ks, const double (&x)[S][R],
                              const double (&b)[S][R],
                              double (&r)[S][R], int n) {
  const int lane = threadIdx.x & 31;
  int off[S];
  column_offsets(off, n);
#pragma unroll 1
  for (int p = 0; p < S; ++p) {
    const int rows = min(kWarp, n - kWarp * p);  // may be <= 0
#pragma unroll 1
    for (int i0 = 0; i0 < rows; i0 += kRowGroup) {
      double sum[R];
      residual_group<R, S>(ks, x, off, n, p, i0, rows, sum);
      const bool mine = lane >= i0 && lane < min(i0 + kRowGroup, rows);
#pragma unroll
      for (int q = 0; q < S; ++q)  // r[p] with p a runtime index
#pragma unroll
        for (int t = 0; t < R; ++t)
          if (q == p && mine) r[q][t] = b[q][t] - sum[t];
    }
  }
}

// m[t] = max_i |v[i, t]| over the warp's rows (NaN-propagating), in
// every lane.
template <int R, int S>
__device__ void warp_absmax(const double (&v)[S][R], int n,
                            double (&m)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    m[t] = 0.0;
#pragma unroll
    for (int q = 0; q < S; ++q)
      if (kWarp * q + lane < n) m[t] = nanmax(m[t], fabs(v[q][t]));
    m[t] = warp_max(m[t]);
  }
}

// ---------------------------------------------------------------------
// ldl_factor: K + diag(reg) = (I + L) D (I + L)^T, no pivoting.
//
// Replaces cuclarabel_tpu/kkt/pallas_dd.py::_factor_impl, whose bodies
// are _ldl_kernel_psc2 (the default, N <= 96) and _ldl_kernel_looped
// (96 < N <= 128); its other bodies compute the same function under
// other TPU schedules.  The JAX kernels eliminate pivot pairs; this one
// eliminates one pivot per step, so the rounding differs and the factor
// is the same.  One departure: a pivot that cancels to exactly zero
// takes its row's regularization reg[j] (ldl_core.cuh::factor_strip).
// The reference has no such guard; its double-float rounding leaves
// such a pivot a tiny nonzero, where f64 gives exactly zero and an
// infinite D^-1 that fails the whole solve.
//
// Bound: reads K's lower triangle and reg, writes L's strict lower
// triangle, D^-1 and ok: about 0.19 GB at (76, 4096), 0.058 ms at
// 3.35 TB/s, against 0.61 G multiplies and adds (0.037 ms of f64 issue
// at 16.7 T/s): memory-bound.  The kernel writes L whole, zeros included
// (0.29 GB in all, 0.085 ms), so the (B, N, N) tensor holds no junk
// above the diagonal; no consumer reads those zeros.
// Design: the blocked right-looking factor of ldl_core.cuh
// (factor_blocked): the lower triangle of one problem (25 KB at N = 76,
// 68 KB at N = 128, plus 10-18 KB of panel buffers) stays in shared
// memory for the whole elimination, so K is read once and L written
// once, both coalesced by rows; four warps per problem, so several
// problems share an SM.  Per panel of 8 pivots the strip warps factor
// the strip in registers, then every thread updates the trailing
// triangle in 4 x 4 register tiles: two block barriers per panel (a
// rank-1 update per pivot takes two per pivot), 0.75 shared accesses per
// update (it takes 3), 16 independent updates per thread and pivot.  Bit
// for bit with the plain version.
// Measured (H100 80GB HBM3, 700 W, device time): 0.263 ms at (76, 4096)
// against the 0.058 ms bound, 0.027 ms at (76, 256), 0.021 ms at
// (76, 1); what holds it back is each panel's strip, a chain of shuffle,
// divide and multiply per pivot (ldl_core.cuh).
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kFactorThreads)
    ldl_factor_kernel(const double* __restrict__ K,
                      const double* __restrict__ reg, double* __restrict__ L,
                      double* __restrict__ Dinv, unsigned char* __restrict__ ok,
                      int n) {
  extern __shared__ double smem[];
  const size_t b = blockIdx.x;
  const bool finite = factor_blocked<double>(
      K + b * n * n, reg + b * n, L + b * n * n, Dinv + b * n, smem, n);
  if (threadIdx.x == kWarp * strip_warp()) ok[b] = finite ? 1 : 0;
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
// Bound: reads L's strict lower triangle, D^-1 and b once and writes x,
// about 0.10 GB at (76, 4096): 0.030 ms; 2 N^2 R operations per problem
// are negligible.  What holds a problem back is latency: the 2 (N - 1)
// sequential steps of the two sweeps, and the copy of L into the SM.
// Design: four warps request L's strict triangle at once with
// cp.async into a packed triangle in shared memory (23.4 KB at N = 76:
// 9 resident problems per SM), then warp 0 alone sweeps
// (ldl_core.cuh::warp_solve): x in registers, one shuffle per step, the
// factor entries of kChunk steps loaded ahead, no block barrier after
// the copy, conflict-free shared reads.
// Measured (H100 80GB HBM3, 700 W, device time): 0.069 ms at (76, 4096)
// against the 0.030 ms bound, 0.0099 ms at (76, 256), 0.0095 ms at
// (76, 1).  At B = 1 about half the time is the copy of L (23 KB into
// one SM) and half the sweeps, ~95 cycles a step: a shuffle, a multiply,
// a subtract and a select in a chain.
// ---------------------------------------------------------------------
template <int R, int S>
__global__ void __launch_bounds__(kLoadThreads, 1)
    ldl_solve_kernel(const double* __restrict__ L,
                     const double* __restrict__ Dinv,
                     const double* __restrict__ bg, double* __restrict__ xg,
                     int n) {
  extern __shared__ double ls[];  // tri(n), packed strict lower
  const size_t b = blockIdx.x;
  load_lower_async(L + b * n * n, ls, n, false);
  cp_async_commit();
  double dinv[S], x[S][R];
  load_dinv<double>(Dinv + b * n, dinv, n);
  load_rows<double, R>(bg + b * n * R, x, n);
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x >= kWarp) return;
  warp_solve<double, R>(ls, dinv, x, n);
  store_rows<double, R>(x, xg + b * n * R, n);
}

// ---------------------------------------------------------------------
// kkt_residual: r = b - K x.  K must be symmetric; its lower triangle is
// read.
//
// Replaces pallas_dd.py::_residual_impl (bodies _residual_kernel_c, the
// default, and _residual_kernel).  Those contract over K's leading axis,
// which equals K x for symmetric K, the only K the solver passes (the
// scaled, symmetrically permuted KKT matrix of kkt/dense.py).
//
// Bound: reads K's lower triangle, x and b and writes r, about 0.10 GB
// at (76, 4096): 0.031 ms; 2 N^2 R operations per problem are
// negligible.
// Design: four warps request the triangle at once with cp.async into a
// packed triangle in shared memory (23.4 KB at N = 76), as
// ldl_solve_refine copies K, and then share its row groups: each warp
// sums its groups of 8 rows with ldl_solve_refine's residual sums
// (residual_group), x in registers, so r equals the residual that
// ldl_solve_refine returns, bit for bit.  A kernel that reads K whole
// moves 0.19 GB.
// Measured (H100 80GB HBM3, 700 W, device time): R = 1 0.057 ms at
// (76, 4096), 0.0060 ms at (76, 256), 0.0051 ms at (76, 1); R = 2 0.074,
// 0.0070 and 0.0059 ms.
// ---------------------------------------------------------------------
template <int R, int S>
__global__ void __launch_bounds__(kLoadThreads)
    kkt_residual_kernel(const double* __restrict__ K,
                        const double* __restrict__ xg,
                        const double* __restrict__ bg, double* __restrict__ rg,
                        int n) {
  extern __shared__ double ks[];  // tri(n), packed lower
  const size_t b = blockIdx.x;
  load_lower_async(K + b * n * n, ks, n, true);
  cp_async_commit();
  double x[S][R], bv[S][R];
  load_rows<double, R>(xg + b * n * R, x, n);
  load_rows<double, R>(bg + b * n * R, bv, n);
  int off[S];
  column_offsets(off, n);
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  constexpr int kGroups = kWarp / kRowGroup;  // groups of a 32-row panel
#pragma unroll 1
  for (int gi = warp; gi < kGroups * S; gi += blockDim.x >> 5) {
    const int p = gi / kGroups, i0 = (gi % kGroups) * kRowGroup;
    const int rows = min(kWarp, n - kWarp * p);
    if (i0 >= rows) continue;  // warp-uniform
    double sum[R];
    residual_group<R, S>(ks, x, off, n, p, i0, rows, sum);
    const int lane = threadIdx.x & 31;
    if (lane >= i0 && lane < min(i0 + kRowGroup, rows)) {
      const int i = kWarp * p + lane;
#pragma unroll
      for (int q = 0; q < S; ++q)
#pragma unroll
        for (int t = 0; t < R; ++t)
          if (q == p) rg[(b * n + i) * R + t] = bv[q][t] - sum[t];
    }
  }
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
// O(N^2 R) operations per problem.  Latency holds it back, as for
// ldl_solve, over two solves and two residuals at npass = 1.
// Design: both triangles in shared memory (46.8 KB at N = 76: 4
// resident problems per SM; 132 KB at N = 128) for every pass, so the
// passes read device memory once.  Four warps request L and then K as
// two cp.async groups; warp 0 starts the first solve as soon as L has
// arrived while K is still arriving, and alone runs every pass, every
// vector in registers: the substitutions of ldl_solve, the residual of
// warp_residual (kkt_residual's sums, bit for bit), the acceptance test
// by a warp reduction; no block barrier after the copy.  One loop over
// the passes holds the only copy of the solve and of the residual:
// fully unrolled copies per call and per panel overran the instruction
// cache (the second solve ran 2.4x slower than the first).
// Measured (H100 80GB HBM3, 700 W, device time, npass = 1): R = 1
// 0.268 ms at (76, 4096) against the 0.060 ms bound, 0.031 ms at
// (76, 256), 0.030 ms at (76, 1); R = 2 0.443, 0.041 and 0.041 ms.
// ---------------------------------------------------------------------
// Threads of a refine block: at R = 2 the registers of its vectors
// (about 220 a thread at S = 3) would leave two blocks of four warps per
// SM, so two warps copy there, and four blocks fit, as shared memory
// allows at N = 76.
constexpr int refine_threads(int R) {
  return R == 1 ? kLoadThreads : kLoadThreads / 2;
}

template <int R, int S>
__global__ void __launch_bounds__(refine_threads(R), 1)
    ldl_solve_refine_kernel(const double* __restrict__ K,
                            const double* __restrict__ L,
                            const double* __restrict__ Dinv,
                            const double* __restrict__ bg,
                            double* __restrict__ xg, double* __restrict__ rg,
                            int n, int npass) {
  extern __shared__ double smem[];
  double* ls = smem;          // tri(n), packed strict lower L
  double* ks = ls + tri(n);   // tri(n), packed lower K
  const size_t b = blockIdx.x;
  load_lower_async(L + b * n * n, ls, n, false);
  cp_async_commit();
  load_lower_async(K + b * n * n, ks, n, true);
  cp_async_commit();
  double dinv[S], bv[S][R];
  load_dinv<double>(Dinv + b * n, dinv, n);
  load_rows<double, R>(bg + b * n * R, bv, n);
  // x, r: the accepted iterate and its residual; xn, en: the candidate.
  // Pass 0 solves b and is accepted as it is; pass p > 0 solves the
  // residual, and its x + dx is accepted where max |r| strictly falls.
  // One loop, so one copy of the solve and of the residual code.
  double x[S][R] = {}, r[S][R] = {}, xn[S][R], en[S][R];
  double ne[R], nen[R];
  cp_async_wait<1>();  // L has arrived; K may still be in flight
  __syncthreads();
  if (threadIdx.x >= kWarp) {
    cp_async_wait<0>();
    loaders_arrive();
    return;
  }
  for (int p = 0; p <= npass; ++p) {
#pragma unroll
    for (int q = 0; q < S; ++q)
#pragma unroll
      for (int t = 0; t < R; ++t) xn[q][t] = p == 0 ? bv[q][t] : r[q][t];
    warp_solve<double, R>(ls, dinv, xn, n);
    if (p > 0) {
#pragma unroll
      for (int q = 0; q < S; ++q)
#pragma unroll
        for (int t = 0; t < R; ++t) xn[q][t] = x[q][t] + xn[q][t];
    } else {
      cp_async_wait<0>();  // K was still arriving during the first solve
      wait_for_loaders();
    }
    warp_residual<R>(ks, xn, bv, en, n);
    warp_absmax<R>(en, n, nen);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (p == 0 || nen[t] < ne[t]) {  // warp-uniform: every lane holds both
#pragma unroll
        for (int q = 0; q < S; ++q) {
          x[q][t] = xn[q][t];
          r[q][t] = en[q][t];
        }
        ne[t] = nen[t];
      }
    }
  }
  store_rows<double, R>(x, xg + b * n * R, n);
  store_rows<double, R>(r, rg + b * n * R, n);
}

size_t factor_smem(int n) {
  return sizeof(double) * FactorLayout<double>(n).smem();
}
size_t solve_smem(int n) { return sizeof(double) * tri(n); }
size_t refine_smem(int n) { return sizeof(double) * 2 * tri(n); }

// The one-warp kernels are instantiated per slot count S = 1..4, the
// slots a lane needs at N (ldl_core.cuh::slots), so that a lane computes
// no slot that holds no row.  Each form's launch: its function, shared
// memory cap raised once per device to what N = kMaxN needs.

cudaError_t ready_factor() {
  static DeviceFlags done = {};
  return allow_smem(ldl_factor_kernel, factor_smem(kMaxN), done);
}
template <int R, int S>
cudaError_t ready_solve() {
  static DeviceFlags done = {};
  return allow_smem(ldl_solve_kernel<R, S>, solve_smem(kMaxN), done);
}
template <int R, int S>
cudaError_t ready_residual() {
  static DeviceFlags done = {};
  return allow_smem(kkt_residual_kernel<R, S>, solve_smem(kMaxN), done);
}
template <int R, int S>
cudaError_t ready_refine() {
  static DeviceFlags done = {};
  return allow_smem(ldl_solve_refine_kernel<R, S>, refine_smem(kMaxN), done);
}

template <int R, int S>
int launch_solve(const double* L, const double* Dinv, const double* b,
                 double* x, int B, int n, cudaStream_t stream) {
  cudaError_t e = ready_solve<R, S>();
  if (e != cudaSuccess) return (int)e;
  ldl_solve_kernel<R, S><<<B, kLoadThreads, solve_smem(n), stream>>>(
      L, Dinv, b, x, n);
  return (int)cudaGetLastError();
}

template <int R, int S>
int launch_residual(const double* K, const double* x, const double* b,
                    double* res, int B, int n, cudaStream_t stream) {
  cudaError_t e = ready_residual<R, S>();
  if (e != cudaSuccess) return (int)e;
  kkt_residual_kernel<R, S><<<B, kLoadThreads, solve_smem(n), stream>>>(
      K, x, b, res, n);
  return (int)cudaGetLastError();
}

template <int R, int S>
int launch_refine(const double* K, const double* L, const double* Dinv,
                  const double* b, double* x, double* res, int B, int n,
                  int npass, cudaStream_t stream) {
  cudaError_t e = ready_refine<R, S>();
  if (e != cudaSuccess) return (int)e;
  ldl_solve_refine_kernel<R, S><<<B, refine_threads(R), refine_smem(n),
                                  stream>>>(K, L, Dinv, b, x, res, n, npass);
  return (int)cudaGetLastError();
}

// f(R, S) for the runtime R in {1, 2} and S = slots(n), each passed as a
// std::integral_constant.
template <class F>
int with_form(int r, int n, F&& f) {
  return with_slots(n, [&](auto S) {
    return r == 1 ? f(std::integral_constant<int, 1>{}, S)
                  : f(std::integral_constant<int, 2>{}, S);
  });
}

// Resident blocks per SM of one form at N = n, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
template <class F>
int occupancy(F* kernel, cudaError_t ready, int threads, size_t smem,
              int* blocks) {
  if (ready != cudaSuccess) return (int)ready;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, smem);
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
  cudaError_t e = ready_factor();
  if (e != cudaSuccess) return (int)e;
  ldl_factor_kernel<<<B, kFactorThreads, factor_smem(n),
                      (cudaStream_t)stream>>>(K, reg, L, Dinv, ok, n);
  return (int)cudaGetLastError();
}

int cc_ldl_solve(const double* L, const double* Dinv, const double* b,
                 double* x, int B, int n, int r, void* stream) {
  if (bad_shape(B, n, r)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return with_form(r, n, [&](auto R, auto S) {
    return launch_solve<decltype(R)::value, decltype(S)::value>(
        L, Dinv, b, x, B, n, (cudaStream_t)stream);
  });
}

int cc_kkt_residual(const double* K, const double* x, const double* b,
                    double* res, int B, int n, int r, void* stream) {
  if (bad_shape(B, n, r)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return with_form(r, n, [&](auto R, auto S) {
    return launch_residual<decltype(R)::value, decltype(S)::value>(
        K, x, b, res, B, n, (cudaStream_t)stream);
  });
}

int cc_ldl_solve_refine(const double* K, const double* L, const double* Dinv,
                        const double* b, double* x, double* res, int B, int n,
                        int r, int npass, void* stream) {
  if (bad_shape(B, n, r) || npass < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return with_form(r, n, [&](auto R, auto S) {
    return launch_refine<decltype(R)::value, decltype(S)::value>(
        K, L, Dinv, b, x, res, B, n, npass, (cudaStream_t)stream);
  });
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and threads per block of one kernel's launch at N = n, R = r on the
// current device.  kernel: 0 ldl_factor, 1 ldl_solve, 2 kkt_residual,
// 3 ldl_solve_refine.
int cc_occupancy(int kernel, int n, int r, int* blocks, int* threads) {
  if (bad_shape(1, n, r)) return (int)cudaErrorInvalidValue;
  return with_form(r, n, [&](auto R, auto S) {
    constexpr int kR = decltype(R)::value, kS = decltype(S)::value;
    switch (kernel) {
      case 0:
        *threads = kFactorThreads;
        return occupancy(ldl_factor_kernel, ready_factor(), kFactorThreads,
                         factor_smem(n), blocks);
      case 1:
        *threads = kLoadThreads;
        return occupancy(ldl_solve_kernel<kR, kS>, ready_solve<kR, kS>(),
                         kLoadThreads, solve_smem(n), blocks);
      case 2:
        *threads = kLoadThreads;
        return occupancy(kkt_residual_kernel<kR, kS>,
                         ready_residual<kR, kS>(), kLoadThreads,
                         solve_smem(n), blocks);
      case 3:
        *threads = refine_threads(kR);
        return occupancy(ldl_solve_refine_kernel<kR, kS>,
                         ready_refine<kR, kS>(), refine_threads(kR),
                         refine_smem(n), blocks);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
}

}  // extern "C"
