// The "wide" forms of the batched LDL^T kernels for NVIDIA Hopper
// (sm_90a): the KKT dimensions N > 128 that the one-warp and
// shared-triangle forms of ldl.cu and ldl_f32.cu do not take.
//
// Six kernels, each computing the function of its narrow form and of its
// TPU counterpart, batch-first and row-major as there: K and L (B, N, N),
// D^-1 (B, N), right-hand sides (B, N, R), R in {1, 2}:
//   ldl_factor_wide_kernel<double>     K1w: pallas_dd.py::_factor_impl
//                                      (_ldl_kernel_looped above N = 96)
//   ldl_solve_wide_kernel<double, R>   K3w / K3rw: _solve_impl, _solve_impl_r
//   kkt_residual_wide_kernel<double, R>  K4w: _residual_impl
//   ldl_solve_refine_wide_kernel<double, R>  K2w / K2rw: _refine_impl,
//                                      _refine_impl_r
//   ldl_factor_wide_kernel<float>      K5w: pallas_ldl.py::_factor_impl
//   ldl_solve_wide_kernel<float, 1>    K6w: pallas_ldl.py::_solve_impl
// kkt/ldl.py and kkt/ldl_f32.py launch them above N = 128 and the narrow
// forms at and below it.
//
// Why the narrow forms stop at 128: the one-warp sweeps keep x in
// ceil(N / 32) <= 4 register slots per lane, the factor keeps the whole
// lower triangle in shared memory with a thread per row, and the refined
// solve keeps both triangles there (132 KB at N = 128; 176 KB at N = 148,
// and above N ~ 168 more than the 227 KB one block may have).  Here one
// block of 256 threads takes one problem, keeps only vectors and one
// panel in shared memory, and reads the triangles from device memory,
// where a problem's rows stay in the L2 while its block works on them.
// The kernels take any N whose panel buffers fit in shared memory (the
// factor's 16 N words: N <= ~1,800 in f64), with size_t offsets.
//
// The contract of the narrow forms holds:
//  - the factor is bit for bit its plain version (kkt/ldl.py::_factor):
//    each element takes its rank-1 updates in pivot order,
//    a_ik -= a_ij * l_kj with l_kj = a_kj * D^-1_j rounded before the
//    product, and the product before the subtraction (-fmad=false); a
//    pivot that cancels to exactly zero takes reg[j] (F7); only K's lower
//    triangle is read, and L is written whole, zeros on and above the
//    diagonal;
//  - the substitution is bit for bit _solve: row i takes its forward
//    updates in ascending j, then D^-1, then the backward updates in
//    descending i;
//  - the residual sums in one order, which kkt_residual_wide and
//    ldl_solve_refine_wide share (block_residual), so the refined solve's
//    returned r equals kkt_residual_wide's bit for bit;
//  - the refined solve accepts a pass per right-hand side only where the
//    NaN-propagating max |r| strictly falls.
//
// Host interface: plain C functions returning cudaGetLastError() after
// the launch, with the narrow forms' signatures, called from kkt/ldl.py
// and kkt/ldl_f32.py through ctypes.  No kernel allocates or
// synchronises; all launch on the caller's stream.

#include "ldl_core.cuh"

namespace {

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / kWarp;
constexpr int kWidePanel = 8;  // pivots per panel of the factor
constexpr int kWideMaxR = 2;

// The dynamic shared memory of every wide kernel, typed by each.
extern __shared__ __align__(16) unsigned char wide_smem[];

// max that propagates NaN, like torch.amax: a NaN residual must never
// look small to the acceptance test.
template <class T>
__device__ inline T nanmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// ---------------------------------------------------------------------
// The factor: K + diag(reg) = (I + L) D (I + L)^T, no pivoting.
//
// Right-looking, in panels of kWidePanel = 8 pivots.  The working lower
// triangle lives in L's own output rows in device memory (the first
// panel reads it from K, adding reg on the diagonal, and writes its
// updates to L, so K is read once and never written).  Per panel j0:
//  (a) the strip, rows i >= j0 of columns j0 .. j0 + 7, is copied into
//      shared memory, sa[c][i];
//  (b) its 8 pivots are eliminated there, one block barrier each: every
//      thread takes D^-1_j = 1 / a_jj itself (exact zero: reg[j]), and
//      for its rows i > j writes l_ij = a_ij * D^-1_j into sl[p][i] and
//      updates the strip's later columns, a_ic -= a_ij * l_cj, l_cj
//      recomputed from a_cj as its own row's thread computes it (the
//      same product, so the same bits);
//  (c) L's columns j0 .. j0 + 7 are written whole: l below the
//      diagonal, zeros on and above it;
//  (d) the trailing triangle, rows and columns >= j0 + 8, takes the
//      panel's 8 updates in pivot order, one warp per row and lanes on
//      consecutive columns (coalesced): the row's 8 a_ij in registers,
//      l_kj from shared memory, each element read once and written once;
//  (e) one block barrier, so the next strip sees the updates.
// So every element receives the subtractions of the plain version in its
// order, with its rounding.
//
// Bound: as the narrow form, the triangles of K and L, D^-1 and ok
// (kernel_timing.work): 0.72 GB at (148, 4096), 0.21 ms at 3.35 TB/s.
// This design moves the trailing triangle through the L2 once per panel,
// about N^3 / 48 words read and as many written per problem (1.08 MB at
// N = 148, 4.4 GB at B = 4096): what does not stay in the L2 goes to
// device memory.  A
// design that keeps the triangle in shared memory (N <~ 237) or in a
// cluster's distributed shared memory is later work.
// The f32 form passes reg and ok as nullptr: no regularisation, no flags.
// ---------------------------------------------------------------------
template <class T>
__global__ void __launch_bounds__(kWideThreads)
    ldl_factor_wide_kernel(const T* __restrict__ K, const T* __restrict__ reg,
                           T* __restrict__ L, T* __restrict__ Dinv,
                           unsigned char* __restrict__ ok, int n) {
  T* sa = reinterpret_cast<T*>(wide_smem);  // [kWidePanel][n]: a_ij
  T* sl = sa + kWidePanel * n;              // [kWidePanel][n]: l_ij
  const size_t b = blockIdx.x;
  const size_t nn = (size_t)n * n;
  const T* Kb = K + b * nn;
  T* Lb = L + b * nn;
  const T* rb = reg != nullptr ? reg + b * n : nullptr;
  T* db = Dinv + b * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bool finite = true;
#pragma unroll 1
  for (int j0 = 0; j0 < n; j0 += kWidePanel) {
    const int P = min(kWidePanel, n - j0);
    const bool first = j0 == 0;
    const T* src = first ? Kb : Lb;  // the working lower triangle
    // (a) the strip, lower entries only (junk above the diagonal unread)
    for (int e = threadIdx.x; e < (n - j0) * P; e += blockDim.x) {
      const int i = j0 + e / P, c = e % P, k = j0 + c;
      T v = T(0);
      if (k <= i) {
        v = src[(size_t)i * n + k];
        if (first && k == i && rb != nullptr) v += rb[i];  // K + diag(reg)
      }
      sa[c * n + i] = v;
    }
    __syncthreads();
    // (b) the panel's pivots
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
      const int j = j0 + p;
      T d = sa[p * n + j];
      if (rb != nullptr && d == T(0)) d = rb[j];
      const T dj = T(1) / d;
      if (threadIdx.x == 0) {
        db[j] = dj;
        finite = finite && isfinite(dj);
      }
      for (int i = j + 1 + threadIdx.x; i < n; i += blockDim.x) {
        const T a = sa[p * n + i];
        sl[p * n + i] = a * dj;
        for (int c = p + 1; c < P && j0 + c <= i; ++c) {
          const T lc = sa[p * n + j0 + c] * dj;
          sa[c * n + i] = sa[c * n + i] - a * lc;
        }
      }
      __syncthreads();
    }
    // (c) L's columns of the panel
    for (int e = threadIdx.x; e < n * P; e += blockDim.x) {
      const int i = e / P, c = e % P;
      Lb[(size_t)i * n + j0 + c] = i > j0 + c ? sl[c * n + i] : T(0);
    }
    // (d) the trailing triangle (P = kWidePanel whenever it is not empty)
    const int t0 = j0 + P;
    for (int i = t0 + warp; i < n; i += kWideWarps) {
      T a[kWidePanel];
#pragma unroll
      for (int p = 0; p < kWidePanel; ++p) a[p] = sa[p * n + i];
      const T* srow = src + (size_t)i * n;
      T* lrow = Lb + (size_t)i * n;
      for (int k = t0 + lane; k <= i; k += kWarp) {
        T v = srow[k];
        if (first && k == i && rb != nullptr) v += rb[i];
#pragma unroll
        for (int p = 0; p < kWidePanel; ++p) v = v - a[p] * sl[p * n + k];
        lrow[k] = v;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && ok != nullptr) ok[b] = finite ? 1 : 0;
}

// ---------------------------------------------------------------------
// x := ((I + L) D (I + L)^T)^-1 x by the calling block, x (n, R) in
// shared memory; L the problem's strict-lower factor in device memory,
// dinv its D^-1.  Ends with a block barrier.
//
// Both sweeps go by 32-row panels.  Forward, panel p0: warp 0 solves the
// diagonal block, lane l owning row p0 + l in registers, one shuffle of
// the final x_j per step, the lane's row of the block loaded before the
// steps; then every thread applies the panel's 32 columns to its rows
// below the panel, ascending, its row's 32 entries loaded first.  So row
// i takes the updates of the earlier panels, then of its own, each in
// ascending j: _solve's order.  Backward the same from the last panel,
// lane l owning column p0 + l and the block's rows read by lanes on
// consecutive columns; every thread then applies the panel's rows to its
// columns before the panel, descending: each x_j takes its updates in
// descending i.  Two block barriers per panel and sweep.
// ---------------------------------------------------------------------
template <class T, int R>
__device__ void block_solve(const T* __restrict__ L,
                            const T* __restrict__ dinv, T* xs, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int panels = (n + kWarp - 1) / kWarp;
#pragma unroll 1
  for (int pp = 0; pp < panels; ++pp) {
    const int p0 = kWarp * pp, rows = min(kWarp, n - p0);
    if (warp == 0) {
      const int i = p0 + lane;
      const bool in = lane < rows;
      T l[kWarp], x[R];
#pragma unroll
      for (int c = 0; c < kWarp; ++c)
        l[c] = in && c < lane ? L[(size_t)i * n + p0 + c] : T(0);
#pragma unroll
      for (int t = 0; t < R; ++t) x[t] = in ? xs[i * R + t] : T(0);
#pragma unroll
      for (int c = 0; c < kWarp - 1; ++c) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const T xj = __shfl_sync(kFullMask, x[t], c);
          const T v = x[t] - l[c] * xj;
          x[t] = in && lane > c ? v : x[t];
        }
      }
      if (in) {
#pragma unroll
        for (int t = 0; t < R; ++t) xs[i * R + t] = x[t];
      }
    }
    __syncthreads();
    // rows below the panel (there the panel has all 32 rows)
    for (int i = p0 + kWarp + threadIdx.x; i < n; i += blockDim.x) {
      const T* row = L + (size_t)i * n + p0;
      T l[kWarp], v[R];
#pragma unroll
      for (int c = 0; c < kWarp; ++c) l[c] = row[c];
#pragma unroll
      for (int t = 0; t < R; ++t) v[t] = xs[i * R + t];
#pragma unroll
      for (int c = 0; c < kWarp; ++c)
#pragma unroll
        for (int t = 0; t < R; ++t)
          v[t] = v[t] - l[c] * xs[(p0 + c) * R + t];
#pragma unroll
      for (int t = 0; t < R; ++t) xs[i * R + t] = v[t];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T d = dinv[i];
#pragma unroll
    for (int t = 0; t < R; ++t) xs[i * R + t] *= d;
  }
  __syncthreads();
#pragma unroll 1
  for (int pp = panels - 1; pp >= 0; --pp) {
    const int p0 = kWarp * pp, rows = min(kWarp, n - p0);
    if (warp == 0) {
      const int j = p0 + lane;
      const bool in = lane < rows;
      T l[kWarp], x[R];  // l[c] = L_ij, i = p0 + c
#pragma unroll
      for (int c = 0; c < kWarp; ++c)
        l[c] = in && c > lane && c < rows ? L[(size_t)(p0 + c) * n + j]
                                          : T(0);
#pragma unroll
      for (int t = 0; t < R; ++t) x[t] = in ? xs[j * R + t] : T(0);
#pragma unroll
      for (int c = kWarp - 1; c > 0; --c) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const T xi = __shfl_sync(kFullMask, x[t], c);
          const T v = x[t] - l[c] * xi;
          x[t] = in && lane < c && c < rows ? v : x[t];
        }
      }
      if (in) {
#pragma unroll
        for (int t = 0; t < R; ++t) xs[j * R + t] = x[t];
      }
    }
    __syncthreads();
    // columns before the panel
    for (int j = threadIdx.x; j < p0; j += blockDim.x) {
      T l[kWarp], v[R];
#pragma unroll
      for (int c = 0; c < kWarp; ++c)
        l[c] = c < rows ? L[(size_t)(p0 + c) * n + j] : T(0);
#pragma unroll
      for (int t = 0; t < R; ++t) v[t] = xs[j * R + t];
#pragma unroll
      for (int c = kWarp - 1; c >= 0; --c) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const T w = v[t] - l[c] * xs[(p0 + min(c, rows - 1)) * R + t];
          v[t] = c < rows ? w : v[t];
        }
      }
#pragma unroll
      for (int t = 0; t < R; ++t) xs[j * R + t] = v[t];
    }
    __syncthreads();
  }
}

// r = b - K x for the symmetric K of the problem's lower triangle in
// device memory, x (n, R) in shared memory, b and r (n, R) anywhere;
// rows dealt out to the block's warps in turn.  For row i, lane l sums
// K_ik x_k over its k = l + 32 q in ascending q (K_ik from row i for
// k <= i, from column i of row k above the diagonal), and the 32 partial
// sums are added along a butterfly (lane ^ 16, ^ 8, ^ 4, ^ 2, ^ 1): one
// order, shared by kkt_residual_wide and ldl_solve_refine_wide.
template <class T, int R>
__device__ void block_residual(const T* __restrict__ K, const T* xs,
                               const T* bs, T* rs, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += blockDim.x >> 5) {
    const T* row = K + (size_t)i * n;
    T s[R];
#pragma unroll
    for (int t = 0; t < R; ++t) s[t] = T(0);
#pragma unroll 4
    for (int k = lane; k < n; k += kWarp) {
      const T kik = k <= i ? row[k] : K[(size_t)k * n + i];
#pragma unroll
      for (int t = 0; t < R; ++t) s[t] = s[t] + kik * xs[k * R + t];
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
#pragma unroll
      for (int t = 0; t < R; ++t) s[t] += __shfl_xor_sync(kFullMask, s[t], o);
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < R; ++t) rs[i * R + t] = bs[i * R + t] - s[t];
    }
  }
}

// m[t] = max_i |v[i, t]| (NaN-propagating) in every thread of the block;
// red holds kWideWarps * R words.  Synchronises the block.
template <class T, int R>
__device__ void block_absmax(const T* v, int n, T* red, T (&m)[R]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < R; ++t) m[t] = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
#pragma unroll
    for (int t = 0; t < R; ++t) m[t] = nanmax(m[t], fabs(v[i * R + t]));
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
#pragma unroll
    for (int t = 0; t < R; ++t)
      m[t] = nanmax(m[t], __shfl_xor_sync(kFullMask, m[t], o));
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < R; ++t) red[warp * R + t] = m[t];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < R; ++t) {
    m[t] = red[t];
    for (int w = 1; w < kWideWarps; ++w) m[t] = nanmax(m[t], red[w * R + t]);
  }
}

// ---------------------------------------------------------------------
// ldl_solve_wide: x = ((I + L) D (I + L)^T)^-1 b, b in shared memory for
// the sweeps.  Bound: L's strict triangle, D^-1, b and x: 0.37 GB at
// (148, 4096), 0.11 ms.
// ---------------------------------------------------------------------
template <class T, int R>
__global__ void __launch_bounds__(kWideThreads)
    ldl_solve_wide_kernel(const T* __restrict__ L, const T* __restrict__ Dinv,
                          const T* __restrict__ bg, T* __restrict__ xg,
                          int n) {
  T* xs = reinterpret_cast<T*>(wide_smem);  // (n, R)
  const size_t b = blockIdx.x;
  const T* bb = bg + b * n * R;
  for (int e = threadIdx.x; e < n * R; e += blockDim.x) xs[e] = bb[e];
  __syncthreads();
  block_solve<T, R>(L + b * n * n, Dinv + b * n, xs, n);
  T* xb = xg + b * n * R;
  for (int e = threadIdx.x; e < n * R; e += blockDim.x) xb[e] = xs[e];
}

// ---------------------------------------------------------------------
// kkt_residual_wide: r = b - K x, K symmetric, its lower triangle read;
// x in shared memory.  Bound: K's lower triangle, x, b and r: 0.37 GB at
// (148, 4096), 0.11 ms.
// ---------------------------------------------------------------------
template <class T, int R>
__global__ void __launch_bounds__(kWideThreads)
    kkt_residual_wide_kernel(const T* __restrict__ K, const T* __restrict__ xg,
                             const T* __restrict__ bg, T* __restrict__ rg,
                             int n) {
  T* xs = reinterpret_cast<T*>(wide_smem);  // (n, R)
  const size_t b = blockIdx.x;
  const T* xb = xg + b * n * R;
  for (int e = threadIdx.x; e < n * R; e += blockDim.x) xs[e] = xb[e];
  __syncthreads();
  block_residual<T, R>(K + b * n * n, xs, bg + b * n * R, rg + b * n * R,
                       n);
}

// ---------------------------------------------------------------------
// ldl_solve_refine_wide: x = solve(b), then npass passes of
// x' = x + solve(b - K x), each accepted per right-hand side only where
// max |b - K x'| < max |b - K x| strictly; returns the accepted x and its
// own r = b - K x.  K symmetric, its lower triangle read.  Every vector
// (b, x, r and the candidate x', r') in shared memory, 5 N R words; the
// passes run block_solve and block_residual, the kernels' own bodies.
// Bound: the triangles of K and L once, D^-1, b, x and r: 0.73 GB at
// (148, 4096), 0.22 ms.
// ---------------------------------------------------------------------
template <class T, int R>
__global__ void __launch_bounds__(kWideThreads)
    ldl_solve_refine_wide_kernel(const T* __restrict__ K,
                                 const T* __restrict__ L,
                                 const T* __restrict__ Dinv,
                                 const T* __restrict__ bg,
                                 T* __restrict__ xg, T* __restrict__ rg,
                                 int n, int npass) {
  const int nr = n * R;
  T* bs = reinterpret_cast<T*>(wide_smem);
  T* x = bs + nr;   // the accepted iterate
  T* r = x + nr;    // its residual
  T* xn = r + nr;   // the candidate
  T* en = xn + nr;  // its residual
  T* red = en + nr;  // kWideWarps * R
  const size_t b = blockIdx.x;
  const T* Kb = K + b * n * n;
  const T* Lb = L + b * n * n;
  const T* db = Dinv + b * n;
  const T* bb = bg + b * nr;
  for (int e = threadIdx.x; e < nr; e += blockDim.x) bs[e] = xn[e] = bb[e];
  __syncthreads();
  T ne[R];
#pragma unroll 1
  for (int p = 0; p <= npass; ++p) {
    // xn holds b (pass 0) or the accepted residual
    block_solve<T, R>(Lb, db, xn, n);
    if (p > 0) {
      for (int e = threadIdx.x; e < nr; e += blockDim.x) xn[e] = x[e] + xn[e];
      __syncthreads();
    }
    block_residual<T, R>(Kb, xn, bs, en, n);
    __syncthreads();
    T nen[R];
    block_absmax<T, R>(en, n, red, nen);
    bool take[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      take[t] = p == 0 || nen[t] < ne[t];
      ne[t] = take[t] ? nen[t] : ne[t];
    }
    for (int e = threadIdx.x; e < nr; e += blockDim.x) {
      if (take[e % R]) {
        x[e] = xn[e];
        r[e] = en[e];
      }
    }
    __syncthreads();
    if (p < npass) {
      for (int e = threadIdx.x; e < nr; e += blockDim.x) xn[e] = r[e];
      __syncthreads();
    }
  }
  T* xb = xg + b * nr;
  T* rb = rg + b * nr;
  for (int e = threadIdx.x; e < nr; e += blockDim.x) {
    xb[e] = x[e];
    rb[e] = r[e];
  }
}

template <class T>
size_t factor_smem(int n) { return sizeof(T) * 2 * kWidePanel * (size_t)n; }
template <class T>
size_t vector_smem(int n, int r) { return sizeof(T) * (size_t)n * r; }
template <class T>
size_t refine_smem(int n, int r) {
  return sizeof(T) * (5 * (size_t)n * r + kWideWarps * r);
}

// Raise a kernel's dynamic shared memory cap to all that one block of
// the current device may opt into, once per kernel and device; a launch
// that asks for more fails and its wrapper raises.
template <class F>
cudaError_t allow_all_smem(F* kernel, DeviceFlags& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev]) return cudaSuccess;
  int bytes = 0;
  e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && known) done[dev] = true;
  return e;
}

template <class T>
cudaError_t ready_factor() {
  static DeviceFlags done = {};
  return allow_all_smem(ldl_factor_wide_kernel<T>, done);
}
template <class T, int R>
cudaError_t ready_solve() {
  static DeviceFlags done = {};
  return allow_all_smem(ldl_solve_wide_kernel<T, R>, done);
}
template <int R>
cudaError_t ready_residual() {
  static DeviceFlags done = {};
  return allow_all_smem(kkt_residual_wide_kernel<double, R>, done);
}
template <int R>
cudaError_t ready_refine() {
  static DeviceFlags done = {};
  return allow_all_smem(ldl_solve_refine_wide_kernel<double, R>, done);
}

template <class T>
int launch_factor(const T* K, const T* reg, T* L, T* Dinv,
                  unsigned char* ok, int B, int n, cudaStream_t stream) {
  cudaError_t e = ready_factor<T>();
  if (e != cudaSuccess) return (int)e;
  ldl_factor_wide_kernel<T><<<B, kWideThreads, factor_smem<T>(n), stream>>>(
      K, reg, L, Dinv, ok, n);
  return (int)cudaGetLastError();
}

template <class T, int R>
int launch_solve(const T* L, const T* Dinv, const T* b, T* x, int B, int n,
                 cudaStream_t stream) {
  cudaError_t e = ready_solve<T, R>();
  if (e != cudaSuccess) return (int)e;
  ldl_solve_wide_kernel<T, R><<<B, kWideThreads, vector_smem<T>(n, R),
                                stream>>>(L, Dinv, b, x, n);
  return (int)cudaGetLastError();
}

template <int R>
int launch_residual(const double* K, const double* x, const double* b,
                    double* res, int B, int n, cudaStream_t stream) {
  cudaError_t e = ready_residual<R>();
  if (e != cudaSuccess) return (int)e;
  kkt_residual_wide_kernel<double, R><<<B, kWideThreads,
                                        vector_smem<double>(n, R), stream>>>(
      K, x, b, res, n);
  return (int)cudaGetLastError();
}

template <int R>
int launch_refine(const double* K, const double* L, const double* Dinv,
                  const double* b, double* x, double* res, int B, int n,
                  int npass, cudaStream_t stream) {
  cudaError_t e = ready_refine<R>();
  if (e != cudaSuccess) return (int)e;
  ldl_solve_refine_wide_kernel<double, R><<<B, kWideThreads,
                                            refine_smem<double>(n, R),
                                            stream>>>(K, L, Dinv, b, x, res,
                                                      n, npass);
  return (int)cudaGetLastError();
}

template <class F>
int occupancy(F* kernel, cudaError_t ready, size_t smem, int* blocks) {
  if (ready != cudaSuccess) return (int)ready;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kWideThreads, smem);
}

bool bad_shape(int B, int n, int r) {
  return B < 0 || n < 1 || r < 1 || r > kWideMaxR;
}

}  // namespace

extern "C" {

int cc_ldl_factor_wide(const double* K, const double* reg, double* L,
                       double* Dinv, unsigned char* ok, int B, int n,
                       void* stream) {
  if (bad_shape(B, n, 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch_factor<double>(K, reg, L, Dinv, ok, B, n,
                               (cudaStream_t)stream);
}

int cc_ldl_solve_wide(const double* L, const double* Dinv, const double* b,
                      double* x, int B, int n, int r, void* stream) {
  if (bad_shape(B, n, r)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return r == 1 ? launch_solve<double, 1>(L, Dinv, b, x, B, n,
                                          (cudaStream_t)stream)
                : launch_solve<double, 2>(L, Dinv, b, x, B, n,
                                          (cudaStream_t)stream);
}

int cc_kkt_residual_wide(const double* K, const double* x, const double* b,
                         double* res, int B, int n, int r, void* stream) {
  if (bad_shape(B, n, r)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return r == 1 ? launch_residual<1>(K, x, b, res, B, n, (cudaStream_t)stream)
                : launch_residual<2>(K, x, b, res, B, n,
                                     (cudaStream_t)stream);
}

int cc_ldl_solve_refine_wide(const double* K, const double* L,
                             const double* Dinv, const double* b, double* x,
                             double* res, int B, int n, int r, int npass,
                             void* stream) {
  if (bad_shape(B, n, r) || npass < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return r == 1 ? launch_refine<1>(K, L, Dinv, b, x, res, B, n, npass,
                                   (cudaStream_t)stream)
                : launch_refine<2>(K, L, Dinv, b, x, res, B, n, npass,
                                   (cudaStream_t)stream);
}

// The f32 forms: the factor's body without regularisation, and the
// substitution for one right-hand side.
int cc_ldl_factor_wide_f32(const float* K, float* L, float* Dinv, int B,
                           int n, void* stream) {
  if (bad_shape(B, n, 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch_factor<float>(K, nullptr, L, Dinv, nullptr, B, n,
                              (cudaStream_t)stream);
}

int cc_ldl_solve_wide_f32(const float* L, const float* Dinv, const float* b,
                          float* x, int B, int n, void* stream) {
  if (bad_shape(B, n, 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch_solve<float, 1>(L, Dinv, b, x, B, n, (cudaStream_t)stream);
}

// Resident blocks per SM and threads per block of one wide kernel's
// launch at N = n, R = r on the current device.  kernel: 0 ldl_factor,
// 1 ldl_solve, 2 kkt_residual, 3 ldl_solve_refine (f64), 4
// ldl_factor_batched, 5 ldl_solve_batched (f32).
int cc_occupancy_wide(int kernel, int n, int r, int* blocks, int* threads) {
  if (bad_shape(1, n, r)) return (int)cudaErrorInvalidValue;
  *threads = kWideThreads;
  const bool one = r == 1;
  switch (kernel) {
    case 0:
      return occupancy(ldl_factor_wide_kernel<double>,
                       ready_factor<double>(), factor_smem<double>(n),
                       blocks);
    case 1:
      return one ? occupancy(ldl_solve_wide_kernel<double, 1>,
                             ready_solve<double, 1>(),
                             vector_smem<double>(n, 1), blocks)
                 : occupancy(ldl_solve_wide_kernel<double, 2>,
                             ready_solve<double, 2>(),
                             vector_smem<double>(n, 2), blocks);
    case 2:
      return one ? occupancy(kkt_residual_wide_kernel<double, 1>,
                             ready_residual<1>(), vector_smem<double>(n, 1),
                             blocks)
                 : occupancy(kkt_residual_wide_kernel<double, 2>,
                             ready_residual<2>(), vector_smem<double>(n, 2),
                             blocks);
    case 3:
      return one ? occupancy(ldl_solve_refine_wide_kernel<double, 1>,
                             ready_refine<1>(), refine_smem<double>(n, 1),
                             blocks)
                 : occupancy(ldl_solve_refine_wide_kernel<double, 2>,
                             ready_refine<2>(), refine_smem<double>(n, 2),
                             blocks);
    case 4:
      return occupancy(ldl_factor_wide_kernel<float>, ready_factor<float>(),
                       factor_smem<float>(n), blocks);
    case 5:
      return occupancy(ldl_solve_wide_kernel<float, 1>,
                       ready_solve<float, 1>(), vector_smem<float>(n, 1),
                       blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
