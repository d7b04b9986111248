// The "wide" forms of the batched LDL^T kernels for NVIDIA Hopper
// (sm_90a): the KKT dimensions N > 128 that the one-warp and
// shared-triangle forms of ldl.cu and ldl_f32.cu do not take.
//
// Six kernels, each computing the function of its narrow form and of its
// TPU counterpart, batch-first and row-major as there: K and L (B, N, N),
// D^-1 (B, N), right-hand sides (B, N, R), R in {1, 2}:
//   ldl_factor_wide_kernel<double, F>  K1w: pallas_dd.py::_factor_impl
//                                      (_ldl_kernel_looped above N = 96)
//   ldl_solve_wide_kernel<double, R, S>  K3w / K3rw: _solve_impl,
//                                      _solve_impl_r
//   kkt_residual_wide_kernel<double, R>  K4w: _residual_impl
//   ldl_solve_refine_wide_kernel<double, R, S>  K2w / K2rw: _refine_impl,
//                                      _refine_impl_r
//   ldl_factor_wide_kernel<float, F>   K5w: pallas_ldl.py::_factor_impl
//   ldl_solve_wide_kernel<float, 1, S> K6w: pallas_ldl.py::_solve_impl
// kkt/ldl.py and kkt/ldl_f32.py launch them above N = 128 and the narrow
// forms at and below it.
//
// Why the narrow forms stop at 128: the one-warp sweeps keep x in
// ceil(N / 32) <= 4 register slots per lane, the factor keeps the whole
// lower triangle in shared memory with a thread per row in a block of
// 128, and the refined solve keeps both triangles there (132 KB at
// N = 128; 176 KB at N = 148, and above N ~ 168 more than the 227 KB one
// block may have).  Here one block takes one problem, and the factor,
// the substitution and the refined solve each have two forms, which the
// launcher picks from N and what one block of the device may opt into
// (factor_form, solve_form, refine_form; on an H100):
//  - "shared" (F = 1, S = ceil(N / 32) > 0): the problem's triangle lives
//    in shared memory.  The factor runs the narrow factor's blocked body
//    (ldl_core.cuh::factor_blocked) in a bigger block and a leaner
//    layout, up to N = 220 (f64) and 320 (f32); the substitution and the
//    refined solve sweep L in one warp (ldl_core.cuh::warp_solve), the
//    substitution up to N = 240 (f64) and 256 (f32), the refined solve
//    up to 233 (R = 1) and 226 (R = 2);
//  - "streaming" (F = 0, S = 0), above: the factor and the substitution
//    keep only vectors and one panel in shared memory and read the
//    triangles from device memory, where a problem's rows stay in the L2
//    while its block works on them; the refined solve sweeps as the
//    substitution does.
// The residual reads K's lower triangle once, in 32 x 32 tiles held in
// registers (block_residual), and the refined solve runs its residuals
// through the same body.  The streaming forms take any N whose panel
// buffers fit in shared memory (the factor's 16 N words: N <= ~1,800 in
// f64), with size_t offsets.
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
// The shared form (F = 1) is the narrow factor's body, factor_blocked
// (ldl_core.cuh), in a block of kSharedFactorThreads (a warp per 32-row
// slot of the first strip, up to 8 in f64 and 10 in f32, and a thread per
// row): K's lower triangle is requested once with cp.async into the 4 x 4
// blocked triangle in shared memory and regularised on the diagonal
// there; each 8-pivot panel's strip is factored in registers by its strip
// warps, and the trailing triangle takes the panel's updates in 4 x 4
// register tiles dealt out afresh each panel, two block barriers per
// panel; L is written once at the end, whole.  The trailing triangle
// never leaves the SM, so device traffic is the bound's own: K's
// triangle in, L, D^-1 and ok out.  The layout pads its arrays to 32 mod
// 64 bytes (the narrow factor's 32 mod 128 costs 4 KB more at N = 148):
// 114,592 bytes at N = 148, so that two blocks share an SM's 228 KB; it
// fits the 227 KB one block may have up to N = 220 (f64) and N = 320
// (f32, where the block's threads end it).  Every element takes the
// plain version's updates in its order, as in the narrow factor.
//
// The streaming form (F = 0), above the fit: right-looking, in panels of
// kWidePanel = 8 pivots.  The working lower
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
// design that keeps the triangle in a cluster's distributed shared
// memory above the shared form's fit is later work.
// The f32 forms pass reg and ok as nullptr: no regularisation, no flags.
// ---------------------------------------------------------------------
// the shared factor's block: 8 warps in f64 (two blocks an SM at
// N = 148, 128 registers a thread), 10 in f32 (its fit reaches N = 320)
template <class T>
constexpr int kSharedFactorThreads = sizeof(T) == 8 ? 256 : 320;
template <class T, int F>
constexpr int kFactorBlock = F ? kSharedFactorThreads<T> : kWideThreads;
template <class T, int F>
constexpr int kFactorMinBlocks = F && sizeof(T) == 8 ? 2 : 1;
// the shared factor's layout pads its arrays to 32 mod kLeanPad bytes
constexpr int kLeanPad = 64;

template <class T, int F>
__global__ void __launch_bounds__(kFactorBlock<T, F>, kFactorMinBlocks<T, F>)
    ldl_factor_wide_kernel(const T* __restrict__ K, const T* __restrict__ reg,
                           T* __restrict__ L, T* __restrict__ Dinv,
                           unsigned char* __restrict__ ok, int n) {
  const size_t b = blockIdx.x;
  const size_t nn = (size_t)n * n;
  const T* rb = reg != nullptr ? reg + b * n : nullptr;
  if constexpr (F != 0) {
    constexpr int kT = kSharedFactorThreads<T>;
    const bool finite = factor_blocked<T, kT, kT, kLeanPad>(
        K + b * nn, rb, L + b * nn, Dinv + b * n,
        reinterpret_cast<T*>(wide_smem), n);
    if (ok != nullptr && threadIdx.x == kWarp * strip_warp<kT / kWarp>())
      ok[b] = finite ? 1 : 0;
  } else {
    T* sa = reinterpret_cast<T*>(wide_smem);  // [kWidePanel][n]: a_ij
    T* sl = sa + kWidePanel * n;              // [kWidePanel][n]: l_ij
    const T* Kb = K + b * nn;
    T* Lb = L + b * nn;
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

// ---------------------------------------------------------------------
// The residual r = b - K x of kkt_residual_wide (K4w) and
// ldl_solve_refine_wide (K2w), one arithmetic in both, so that K2w's
// returned r is K4w's bit for bit.  K symmetric, its lower triangle read
// once from device memory, in 32 x 32 tiles, each applied twice.
//
// The lower triangle's nt (nt + 1) / 2 tiles (nt = ceil(n / 32)) are
// numbered row by row, t = tri(I) + J for tile (I, J), J <= I.  The first
// W warps of the block work on them in waves: in wave k, warp w takes
// tile k * W + w.  Lane c loads column c of its tile, 32 words from 32
// rows of K, each row's 32 words one coalesced load of the warp (rows
// and columns past n load as zeros, and a diagonal tile loads only its
// lower half).  Then, per right-hand side:
//  - the column: K_IJ^T x_I for column 32 J + c, the products of rows
//    r = u mod 4 into sum u, the four sums added in pairs,
//    (0 + 1) + (2 + 3);
//  - the rows: lane c multiplies its 32 words by x_J's entry c, and the
//    warp adds the 32 lanes' products row by row in a butterfly that
//    leaves row r's sum in lane r (reduce_rows: five levels, lane offsets
//    16, 8, 4, 2, 1, 31 shuffles a tile);
//  - a diagonal tile gives row r its lower part from the rows and its
//    upper part, the transposed strict lower part, from column r, added
//    in that order; its products above the diagonal are left out, not
//    multiplied by zero.
// After each wave the block adds the wave's partial sums to every row's
// running sum in tile order.  Row i of tile row I thus takes, in
// ascending J, one partial of tile (I, J) (J <= I) or of (J, I)^T
// (J > I): one order, fixed by n alone, whatever the batch, W or the
// block's size; r = b - that sum.  No atomics.
//
// Shared memory (words): the partial sums of one wave, 2 * W * 32 * R;
// the running sums, n * R (`acc`, which may be the output); x.  (A tile
// copied into shared memory and its rows summed in each lane, in the
// butterfly's order, gave the same bits but ran 20% slower in K4w; copies
// by cp.async, 8-byte words straight into shared memory, ran at about
// 8 bytes per cycle per SM on an H100.)
// ---------------------------------------------------------------------
// the in-lane sums of a tile's column: four interleaved chains
constexpr int kLanes = 4;

// (I, J) of tile t: I from a float square root, corrected by one step.
__device__ inline void tile_of(int t, int& I, int& J) {
  I = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  I += tri(I + 1) <= t ? 1 : 0;
  I -= tri(I) > t ? 1 : 0;
  J = t - tri(I);
}

// Lane `lane`'s column of tile (I, J): rg[r] = K[32 I + r][32 J + lane].
template <class T>
__device__ inline void load_tile(const T* __restrict__ K, int n, int I,
                                 int J, T (&rg)[kWarp], int lane) {
  const int c = kWarp * J + lane;
#pragma unroll
  for (int r = 0; r < kWarp; ++r) {
    const int i = kWarp * I + r;
    rg[r] = i < n && c < n && (I != J || lane <= r) ? K[(size_t)i * n + c]
                                                    : T(0);
  }
}

// One level of reduce_rows: lanes H apart pair up; each keeps the H rows
// whose index bit H matches its own, adding its partner's values of them
// into v[0 .. H - 1].  H a template argument, so that every index into v
// is a constant and v stays in registers.
template <int H, class T>
__device__ inline void reduce_level(T (&v)[kWarp], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const T keep = up ? v[r + H] : v[r];
    const T send = up ? v[r] : v[r + H];
    v[r] = keep + __shfl_xor_sync(kFullMask, send, H);
  }
}

// v[r] summed over the warp's lanes for every r, lane r receiving row
// r's sum: a butterfly over lane offsets 16, 8, 4, 2, 1.  Overwrites v.
template <class T>
__device__ inline T reduce_rows(T (&v)[kWarp], int lane) {
  reduce_level<16>(v, lane);
  reduce_level<8>(v, lane);
  reduce_level<4>(v, lane);
  reduce_level<2>(v, lane);
  reduce_level<1>(v, lane);
  return v[0];
}

// rs = bs - K x for x = xs (n, R) in shared memory, bs and rs (n, R)
// anywhere, acc n * R words of shared memory (may be rs), part
// 2 * W * 32 * R words.  All the block's threads call it, xs readable by
// all; ends with each thread writing its own rows, without a barrier.
// With kAhead (K4w) a warp loads its next tile into a second set of
// registers while it works on this one, and keeps the tile for a second
// right-hand side; without (K2w, whose registers are scarcer) a second
// right-hand side reloads the tile from the L2.  The arithmetic is the
// same either way.
template <class T, int R, int W, bool kAhead>
__device__ void block_residual(const T* __restrict__ K, const T* xs,
                               const T* bs, T* rs, T* acc, T* part, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (n + kWarp - 1) / kWarp, tiles = tri(nt);
  const int nr = n * R;
  T vn[kAhead ? kWarp : 1];  // kAhead: the next tile, in flight
  if constexpr (kAhead) {
    if (warp < W && warp < tiles) {
      int I, J;
      tile_of(warp, I, J);
      load_tile(K, n, I, J, vn, lane);
    }
  }
  for (int e = threadIdx.x; e < nr; e += blockDim.x) acc[e] = T(0);
#pragma unroll 1
  for (int t0 = 0; t0 < tiles; t0 += W) {
    const int t = t0 + warp;
    if (warp < W && t < tiles) {
      int I, J;
      tile_of(t, I, J);
      const bool diag = I == J;
      const int c = kWarp * J + lane;
      T* pw = part + 2 * warp * kWarp * R;
      T v[kWarp];
      if constexpr (kAhead) {
#pragma unroll
        for (int r = 0; r < kWarp; ++r) v[r] = vn[r];
        if (t + W < tiles) {
          int In, Jn;
          tile_of(t + W, In, Jn);
          load_tile(K, n, In, Jn, vn, lane);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!kAhead) load_tile(K, n, I, J, v, lane);
        // the lane's column: K_IJ^T x_I (a diagonal tile: rows below it)
        T s[kLanes];
#pragma unroll
        for (int u = 0; u < kLanes; ++u) s[u] = T(0);
#pragma unroll
        for (int r = 0; r < kWarp; ++r) {
          const int i = kWarp * I + r;
          const T xi = i < n ? xs[i * R + q] : T(0);
          const T w = s[r % kLanes] + v[r] * xi;
          s[r % kLanes] = diag && r <= lane ? s[r % kLanes] : w;
        }
        const T col = (s[0] + s[1]) + (s[2] + s[3]);
        // the rows: K_IJ x_J, summed over the lanes (a diagonal tile: its
        // lower half)
        const T xc = c < n ? xs[c * R + q] : T(0);
        T row;
        if (kAhead && q + 1 < R) {  // the tile is needed again
          T p[kWarp];
#pragma unroll
          for (int r = 0; r < kWarp; ++r)
            p[r] = diag && lane > r ? T(0) : v[r] * xc;
          row = reduce_rows(p, lane);
        } else {
#pragma unroll
          for (int r = 0; r < kWarp; ++r)
            v[r] = diag && lane > r ? T(0) : v[r] * xc;
          row = reduce_rows(v, lane);
        }
        if (diag) {
          pw[lane * R + q] = row + col;
        } else {
          pw[lane * R + q] = row;
          pw[(kWarp + lane) * R + q] = col;
        }
      }
    }
    __syncthreads();
    // the wave's partials, in tile order, into each row's sum
    int I0, J0;
    tile_of(t0, I0, J0);
    for (int e = threadIdx.x; e < nr; e += blockDim.x) {
      const int i = e / R, q = e - i * R, rb = i >> 5, l = i & 31;
      T sum = acc[e];
      int I = I0, J = J0;
      for (int w = 0; w < W && t0 + w < tiles; ++w) {
        const T* pw = part + 2 * w * kWarp * R;
        if (I == rb)
          sum = sum + pw[l * R + q];
        else if (J == rb)
          sum = sum + pw[(kWarp + l) * R + q];
        J = J < I ? J + 1 : 0;
        I = J == 0 ? I + 1 : I;
      }
      acc[e] = sum;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nr; e += blockDim.x) rs[e] = bs[e] - acc[e];
}

// the residual's warps: four in kkt_residual_wide (a block of its own),
// all eight in ldl_solve_refine_wide
constexpr int kResWarps = 4;
constexpr int kRefineResWarps = kWideWarps;

template <class T>
size_t residual_smem(int r, int w) {
  return sizeof(T) * 2 * (size_t)w * kWarp * r;
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
// ldl_solve_wide: x = ((I + L) D (I + L)^T)^-1 b.  Bound: L's strict
// triangle, D^-1, b and x: 0.37 GB at (148, 4096), 0.11 ms.
//
// Two forms, chosen by the launcher from N and the shared memory one
// block may opt into (solve_form).  S > 0 (the "shared" form,
// S = ceil(N / 32) slots, 5-8): L's strict triangle is copied into shared
// memory, packed by rows (row i at tri(i)) as the refined solve's shared
// form keeps it, and warp 0 sweeps it with the narrow kernels' warp_solve
// (ldl_core.cuh), x in S register slots a lane, one shuffle a step, no
// block barrier, in _solve's order.  The copy overlaps the forward sweep:
// the block's other warps request the triangle as one cp.async group per
// 32-column panel (copy_panels), in the order the sweep needs them, and
// release each panel on its own named barrier once it has arrived; warp 0
// waits there before the panel's first step, so the sweep starts when
// the first panel is in, not the whole triangle, and the backward sweep
// runs on shared memory alone.  A block of kLoadThreads: three warps
// keep the copies in flight, as in the narrow substitution.  Shared
// memory tri(N) words: 88,208 bytes at N = 148 (two blocks an SM); it
// fits the 227 KB one block may have up to N = 240 in f64 (the slots end
// the f32 form at N = 256).
// S = 0 (the "streaming" form, above): b in shared memory, L read from
// device memory by block_solve.
// ---------------------------------------------------------------------
// Request, by the threads of warps 1 and up, L's strict lower triangle
// (row-major (n, n) in device memory) into the packed triangle Ls, row i
// at tri(i), as S cp.async groups: group p holds panel p, the entries
// (i, k) with 32 p <= k < min(32 p + 32, i), of rows i > 32 p.  Lanes on
// consecutive columns of one row: a row's part of a panel is one
// coalesced request (256 bytes in f64).
template <class T, int S>
__device__ void copy_panels(const T* __restrict__ Lb, T* Ls, int n) {
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(Ls));
  const int t = threadIdx.x - kWarp, nt = blockDim.x - kWarp;
#pragma unroll
  for (int p = 0; p < S; ++p) {
    const int p0 = kWarp * p;
    // rows p0 + 1 .. n - 1, 32 columns each (the first 32 rows only in
    // part: k < i)
    const int slots = max(n - 1 - p0, 0) * kWarp;
    for (int e = t; e < slots; e += nt) {
      const int i = p0 + 1 + (e >> 5), k = p0 + (e & 31);
      if (k < i)
        cp_async(s0 + sizeof(T) * (tri(i) + k), Lb + (size_t)i * n + k);
    }
    cp_async_commit();
  }
}

// Wait for this thread's panels P, P + 1, ... S - 1 in order, and
// release each to warp 0 (bar.arrive on named barrier 1 + p: the copying
// warps arrive, warp 0 syncs, so its reads follow every copy of the
// panel).
template <int P, int S>
__device__ void release_panels() {
  if constexpr (P < S) {
    cp_async_wait<S - 1 - P>();
    asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + P), "r"(blockDim.x)
                 : "memory");
    release_panels<P + 1, S>();
  }
}

// warp_solve's wait: panel p of the triangle has arrived (named barrier
// 1 + p, which the copying warps release)
struct PanelArrived {
  __device__ void operator()(int p) const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + p), "r"(blockDim.x)
                 : "memory");
  }
};

template <class T, int R, int S>
__global__ void __launch_bounds__(S > 0 ? kLoadThreads : kWideThreads)
    ldl_solve_wide_kernel(const T* __restrict__ L, const T* __restrict__ Dinv,
                          const T* __restrict__ bg, T* __restrict__ xg,
                          int n) {
  const size_t b = blockIdx.x;
  if constexpr (S > 0) {
    T* Ls = reinterpret_cast<T*>(wide_smem);  // tri(n), row i at tri(i)
    if (threadIdx.x >= kWarp) {
      copy_panels<T, S>(L + b * n * n, Ls, n);
      release_panels<0, S>();
    } else {
      T dinv[S], v[S][R];
      load_dinv<T>(Dinv + b * n, dinv, n);
      load_rows<T, R>(bg + b * n * R, v, n);
      warp_solve<T, R>(Ls, dinv, v, n, PanelArrived());
      store_rows<T, R>(v, xg + b * n * R, n);
    }
  } else {
    T* xs = reinterpret_cast<T*>(wide_smem);  // (n, R)
    const T* bb = bg + b * n * R;
    for (int e = threadIdx.x; e < n * R; e += blockDim.x) xs[e] = bb[e];
    __syncthreads();
    block_solve<T, R>(L + b * n * n, Dinv + b * n, xs, n);
    T* xb = xg + b * n * R;
    for (int e = threadIdx.x; e < n * R; e += blockDim.x) xb[e] = xs[e];
  }
}


// ---------------------------------------------------------------------
// kkt_residual_wide: r = b - K x, K symmetric, its lower triangle read
// once in tiles (block_residual); one block of kResWarps warps per
// problem.  Bound: K's lower triangle, x, b and r: 0.37 GB at
// (148, 4096), 0.11 ms.  Shared memory: the partials, x and the running
// sums (n R words each): 3.3 KB at N = 148, R = 1.
// ---------------------------------------------------------------------
template <class T, int R>
__global__ void __launch_bounds__(kResWarps * kWarp)
    kkt_residual_wide_kernel(const T* __restrict__ K, const T* __restrict__ xg,
                             const T* __restrict__ bg, T* __restrict__ rg,
                             int n) {
  T* part = reinterpret_cast<T*>(wide_smem);
  T* xs = part + 2 * kResWarps * kWarp * R;  // (n, R)
  T* acc = xs + n * R;
  const size_t b = blockIdx.x;
  const T* xb = xg + b * n * R;
  for (int e = threadIdx.x; e < n * R; e += blockDim.x) xs[e] = xb[e];
  __syncthreads();
  block_residual<T, R, kResWarps, true>(K + b * n * n, xs, bg + b * n * R,
                                        rg + b * n * R, acc, part, n);
}

// ---------------------------------------------------------------------
// ldl_solve_refine_wide: x = solve(b), then npass passes of
// x' = x + solve(b - K x), each accepted per right-hand side only where
// max |b - K x'| < max |b - K x| strictly; returns the accepted x and its
// own r = b - K x.  K symmetric, its lower triangle read.  Every vector
// (b, x, r and the candidate x', r') in shared memory, 5 N R words; each
// pass's residual runs block_residual, kkt_residual_wide's body (with
// kRefineResWarps warps).
//
// Two forms, chosen by the launcher from N, R and the shared memory one
// block may opt into (refine_form).  S > 0 (the "shared" form,
// S = ceil(N / 32) slots, 5-8): L's strict lower triangle is copied into shared memory once, packed by
// rows as the narrow kernels keep it (row i at tri(i)), by coalesced
// loads of kCopyBatch words a thread in flight, then stores; every sweep
// of every pass then runs on it in warp 0 alone, the narrow kernels'
// warp_solve with x in S register slots a lane (ldl_core.cuh): one
// shuffle per step and no block barrier, in _solve's order.  88,208
// bytes of L at N = 148, 98,288 in all, so that two blocks share an SM;
// it fits the 227 KB one block may have up to N = 233 (R = 1) and 226
// (R = 2).
// S = 0 (the "streaming" form, above that): every sweep runs block_solve
// on L in device memory, as ldl_solve_wide does.  Bound: the triangles
// of K and L once, D^-1, b, x and r: 0.73 GB at (148, 4096), 0.22 ms.
// ---------------------------------------------------------------------
constexpr int kCopyBatch = 16;
// resident blocks an SM the registers are capped for (128 a thread); at
// R = 2 the sweeps spill 1-1.4 KB a thread under this cap, and still run
// faster at B = 4096 than one block an SM without spills
constexpr int kRefineBlocks = 2;

template <class T, int R, int S>
__global__ void __launch_bounds__(kWideThreads, kRefineBlocks)
    ldl_solve_refine_wide_kernel(const T* __restrict__ K,
                                 const T* __restrict__ L,
                                 const T* __restrict__ Dinv,
                                 const T* __restrict__ bg,
                                 T* __restrict__ xg, T* __restrict__ rg,
                                 int n, int npass) {
  const int nr = n * R;
  T* part = reinterpret_cast<T*>(wide_smem);
  T* bs = part + 2 * kRefineResWarps * kWarp * R;
  T* x = bs + nr;    // the accepted iterate
  T* r = x + nr;     // its residual
  T* xn = r + nr;    // the candidate
  T* en = xn + nr;   // its residual
  T* red = en + nr;  // kWideWarps * R
  T* Ls = red + kWideWarps * R;  // S > 0: tri(n) words, row i at tri(i)
  const size_t b = blockIdx.x;
  const T* Kb = K + b * n * n;
  const T* Lb = L + b * n * n;
  const T* db = Dinv + b * n;
  const T* bb = bg + b * nr;
  if constexpr (S > 0) {
    // element e of the strict triangle, row i + 1 of it being row i of
    // the full triangle of order n - 1, lies at tri(i + 1) + k = e + i + 1
    const int total = tri(n - 1);
    for (int e0 = 0; e0 < total; e0 += kCopyBatch * blockDim.x) {
      T v[kCopyBatch];
      int at[kCopyBatch];
#pragma unroll
      for (int u = 0; u < kCopyBatch; ++u) {
        const int e = e0 + u * blockDim.x + threadIdx.x;
        int i = 0, k = 0;
        if (e < total) tri_index(e, i, k);
        at[u] = e < total ? e + i + 1 : -1;
        v[u] = e < total ? Lb[(size_t)(i + 1) * n + k] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kCopyBatch; ++u)
        if (at[u] >= 0) Ls[at[u]] = v[u];
    }
  }
  for (int e = threadIdx.x; e < nr; e += blockDim.x) bs[e] = xn[e] = bb[e];
  __syncthreads();
  T ne[R];
#pragma unroll 1
  for (int p = 0; p <= npass; ++p) {
    // xn holds b (pass 0) or the accepted residual
    if constexpr (S > 0) {
      if (threadIdx.x < kWarp) {
        T dinv[S], v[S][R];
        load_dinv<T>(db, dinv, n);
        load_rows<T, R>(xn, v, n);
        warp_solve<T, R>(Ls, dinv, v, n);
        store_rows<T, R>(v, xn, n);
      }
      __syncthreads();
    } else {
      block_solve<T, R>(Lb, db, xn, n);
    }
    if (p > 0) {
      for (int e = threadIdx.x; e < nr; e += blockDim.x) xn[e] = x[e] + xn[e];
      __syncthreads();
    }
    block_residual<T, R, kRefineResWarps, false>(Kb, xn, bs, en, en, part,
                                                 n);
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

// f(std::integral_constant<int, S>{}) for S = slots(n), 5-8 (N from 129
// to 256): the instantiations of the shared forms of the substitution
// and the refined solve, launched only where solve_form and refine_form
// pick them; an N outside them returns cudaErrorInvalidValue.
template <class F>
inline int with_shared_slots(int n, F&& f) {
  switch (slots(n)) {
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class T>
size_t factor_smem(int n) { return sizeof(T) * 2 * kWidePanel * (size_t)n; }
template <class T>
size_t shared_factor_smem(int n) {
  return sizeof(T) * (size_t)FactorLayout<T, kLeanPad>(n).smem();
}
template <class T>
size_t vector_smem(int n, int r) { return sizeof(T) * (size_t)n * r; }
template <class T>
size_t shared_solve_smem(int n) { return sizeof(T) * (size_t)tri(n); }
template <class T>
size_t kkt_residual_smem(int n, int r) {
  return residual_smem<T>(r, kResWarps) + sizeof(T) * 2 * (size_t)n * r;
}
template <class T>
size_t refine_smem(int n, int r, bool shared_l) {
  return residual_smem<T>(r, kRefineResWarps) +
         sizeof(T) * (5 * (size_t)n * r + kWideWarps * r +
                      (shared_l ? (size_t)tri(n) : 0));
}

// The shared memory one block of the current device may opt into, in
// bytes; a negative CUDA error where the device cannot be asked.
int smem_optin() {
  int dev = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e == cudaSuccess ? bytes : -(int)e;
}

// The forms of the wide kernels at N = n (and R = r) on the current
// device: 1 ("shared": the problem's triangle in shared memory) where the
// form's layout fits what one block may opt into and its block has the
// warps (the factor) or its instantiation the slots (the sweeps), 0
// ("streaming") elsewhere; a negative CUDA error where the device cannot
// be asked.  The launchers launch the form these pick, and nothing else.
template <class T>
int factor_form(int n) {
  const int bytes = smem_optin();
  if (bytes < 0) return bytes;
  return n <= kSharedFactorThreads<T> &&
         shared_factor_smem<T>(n) <= (size_t)bytes;
}
template <class T>
int solve_form(int n) {
  const int bytes = smem_optin();
  if (bytes < 0) return bytes;
  const int s = slots(n);
  return s >= 5 && s <= 8 && shared_solve_smem<T>(n) <= (size_t)bytes;
}
int refine_form(int n, int r) {
  const int bytes = smem_optin();
  if (bytes < 0) return bytes;
  const int s = slots(n);
  return s >= 5 && s <= 8 && refine_smem<double>(n, r, true) <= (size_t)bytes;
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

template <class T, int F>
cudaError_t ready_factor() {
  static DeviceFlags done = {};
  return allow_all_smem(ldl_factor_wide_kernel<T, F>, done);
}
template <class T, int R, int S>
cudaError_t ready_solve() {
  static DeviceFlags done = {};
  return allow_all_smem(ldl_solve_wide_kernel<T, R, S>, done);
}
template <int R>
cudaError_t ready_residual() {
  static DeviceFlags done = {};
  return allow_all_smem(kkt_residual_wide_kernel<double, R>, done);
}
template <int R, int S>
cudaError_t ready_refine() {
  static DeviceFlags done = {};
  return allow_all_smem(ldl_solve_refine_wide_kernel<double, R, S>, done);
}

// Each form's launch: its block, its shared memory.
template <class T, int F>
int launch_factor_form(const T* K, const T* reg, T* L, T* Dinv,
                       unsigned char* ok, int B, int n, cudaStream_t stream) {
  cudaError_t e = ready_factor<T, F>();
  if (e != cudaSuccess) return (int)e;
  constexpr int kThreads = kFactorBlock<T, F>;
  const size_t smem = F ? shared_factor_smem<T>(n) : factor_smem<T>(n);
  ldl_factor_wide_kernel<T, F><<<B, kThreads, smem, stream>>>(K, reg, L,
                                                              Dinv, ok, n);
  return (int)cudaGetLastError();
}

// In the form factor_form picks at n.
template <class T>
int launch_factor(const T* K, const T* reg, T* L, T* Dinv,
                  unsigned char* ok, int B, int n, cudaStream_t stream) {
  const int form = factor_form<T>(n);
  if (form < 0) return -form;
  return form ? launch_factor_form<T, 1>(K, reg, L, Dinv, ok, B, n, stream)
              : launch_factor_form<T, 0>(K, reg, L, Dinv, ok, B, n, stream);
}

template <class T, int R, int S>
int launch_solve_form(const T* L, const T* Dinv, const T* b, T* x, int B,
                      int n, cudaStream_t stream) {
  cudaError_t e = ready_solve<T, R, S>();
  if (e != cudaSuccess) return (int)e;
  constexpr int kThreads = S > 0 ? kLoadThreads : kWideThreads;
  const size_t smem = S > 0 ? shared_solve_smem<T>(n) : vector_smem<T>(n, R);
  ldl_solve_wide_kernel<T, R, S><<<B, kThreads, smem, stream>>>(L, Dinv, b,
                                                                x, n);
  return (int)cudaGetLastError();
}

// In the form solve_form picks at n.
template <class T, int R>
int launch_solve(const T* L, const T* Dinv, const T* b, T* x, int B, int n,
                 cudaStream_t stream) {
  const int form = solve_form<T>(n);
  if (form < 0) return -form;
  if (form)
    return with_shared_slots(n, [&](auto S) {
      return launch_solve_form<T, R, decltype(S)::value>(L, Dinv, b, x, B, n,
                                                         stream);
    });
  return launch_solve_form<T, R, 0>(L, Dinv, b, x, B, n, stream);
}

template <int R>
int launch_residual(const double* K, const double* x, const double* b,
                    double* res, int B, int n, cudaStream_t stream) {
  cudaError_t e = ready_residual<R>();
  if (e != cudaSuccess) return (int)e;
  kkt_residual_wide_kernel<double, R><<<B, kResWarps * kWarp,
                                        kkt_residual_smem<double>(n, R),
                                        stream>>>(K, x, b, res, n);
  return (int)cudaGetLastError();
}

template <int R, int S>
int launch_refine(const double* K, const double* L, const double* Dinv,
                  const double* b, double* x, double* res, int B, int n,
                  int npass, cudaStream_t stream) {
  cudaError_t e = ready_refine<R, S>();
  if (e != cudaSuccess) return (int)e;
  ldl_solve_refine_wide_kernel<double, R, S><<<B, kWideThreads,
                                               refine_smem<double>(n, R,
                                                                   S > 0),
                                               stream>>>(
      K, L, Dinv, b, x, res, n, npass);
  return (int)cudaGetLastError();
}

template <class F>
int occupancy(F* kernel, cudaError_t ready, int threads, size_t smem,
              int* blocks) {
  if (ready != cudaSuccess) return (int)ready;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem);
}

template <class T, int F>
int factor_occupancy(int n, int* blocks, int* threads) {
  *threads = kFactorBlock<T, F>;
  return occupancy(ldl_factor_wide_kernel<T, F>, ready_factor<T, F>(),
                   *threads,
                   F ? shared_factor_smem<T>(n) : factor_smem<T>(n), blocks);
}

template <class T, int R, int S>
int solve_occupancy(int n, int* blocks, int* threads) {
  *threads = S > 0 ? kLoadThreads : kWideThreads;
  return occupancy(ldl_solve_wide_kernel<T, R, S>, ready_solve<T, R, S>(),
                   *threads,
                   S > 0 ? shared_solve_smem<T>(n) : vector_smem<T>(n, R),
                   blocks);
}

template <class T, int R>
int shared_solve_occupancy(int n, int* blocks, int* threads) {
  return with_shared_slots(n, [&](auto S) {
    return solve_occupancy<T, R, decltype(S)::value>(n, blocks, threads);
  });
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

// The forms the launchers pick on the current device: 1 "shared", 0
// "streaming", a negative CUDA error.  word: the element's bytes, 8 (the
// f64 kernels) or 4 (f32).
int cc_factor_form_wide(int n, int word) {
  if (bad_shape(1, n, 1) || (word != 4 && word != 8))
    return -(int)cudaErrorInvalidValue;
  return word == 8 ? factor_form<double>(n) : factor_form<float>(n);
}

int cc_solve_form_wide(int n, int r, int word) {
  if (bad_shape(1, n, r) || (word != 4 && word != 8) || (word == 4 && r != 1))
    return -(int)cudaErrorInvalidValue;
  return word == 8 ? solve_form<double>(n) : solve_form<float>(n);
}

int cc_refine_form_wide(int n, int r) {
  if (bad_shape(1, n, r)) return -(int)cudaErrorInvalidValue;
  return refine_form(n, r);
}

// In the form refine_form picks at (n, r).
int cc_ldl_solve_refine_wide(const double* K, const double* L,
                             const double* Dinv, const double* b, double* x,
                             double* res, int B, int n, int r, int npass,
                             void* stream) {
  if (bad_shape(B, n, r) || npass < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int form = refine_form(n, r);
  if (form < 0) return -form;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form)
    return with_shared_slots(n, [&](auto S) {
      constexpr int kS = decltype(S)::value;
      return r == 1 ? launch_refine<1, kS>(K, L, Dinv, b, x, res, B, n,
                                           npass, s)
                    : launch_refine<2, kS>(K, L, Dinv, b, x, res, B, n,
                                           npass, s);
    });
  return r == 1 ? launch_refine<1, 0>(K, L, Dinv, b, x, res, B, n, npass, s)
                : launch_refine<2, 0>(K, L, Dinv, b, x, res, B, n, npass, s);
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

// Resident blocks per SM and threads per block of one wide kernel form's
// launch at N = n, R = r on the current device.  kernel: 0 ldl_factor,
// 1 ldl_solve, 2 kkt_residual, 3 ldl_solve_refine (f64), 4
// ldl_factor_batched, 5 ldl_solve_batched (f32), in the streaming forms;
// 6 ldl_solve_refine, 7 ldl_factor, 8 ldl_solve (f64), 9
// ldl_factor_batched, 10 ldl_solve_batched (f32), in the shared forms
// (whose N must have an instantiation: 129-256 for the sweeps).
int cc_occupancy_wide(int kernel, int n, int r, int* blocks, int* threads) {
  if (bad_shape(1, n, r)) return (int)cudaErrorInvalidValue;
  const int W = kWideThreads, RW = kResWarps * kWarp;
  *threads = kernel == 2 ? RW : W;
  const bool one = r == 1;
  switch (kernel) {
    case 0:
      return factor_occupancy<double, 0>(n, blocks, threads);
    case 1:
      return one ? solve_occupancy<double, 1, 0>(n, blocks, threads)
                 : solve_occupancy<double, 2, 0>(n, blocks, threads);
    case 2:
      return one ? occupancy(kkt_residual_wide_kernel<double, 1>,
                             ready_residual<1>(), RW,
                             kkt_residual_smem<double>(n, 1), blocks)
                 : occupancy(kkt_residual_wide_kernel<double, 2>,
                             ready_residual<2>(), RW,
                             kkt_residual_smem<double>(n, 2), blocks);
    case 3:
      return one ? occupancy(ldl_solve_refine_wide_kernel<double, 1, 0>,
                             ready_refine<1, 0>(), W,
                             refine_smem<double>(n, 1, false), blocks)
                 : occupancy(ldl_solve_refine_wide_kernel<double, 2, 0>,
                             ready_refine<2, 0>(), W,
                             refine_smem<double>(n, 2, false), blocks);
    case 4:
      return factor_occupancy<float, 0>(n, blocks, threads);
    case 5:
      return solve_occupancy<float, 1, 0>(n, blocks, threads);
    case 6:
      return with_shared_slots(n, [&](auto S) {
        constexpr int kS = decltype(S)::value;
        return one ? occupancy(ldl_solve_refine_wide_kernel<double, 1, kS>,
                               ready_refine<1, kS>(), W,
                               refine_smem<double>(n, 1, true), blocks)
                   : occupancy(ldl_solve_refine_wide_kernel<double, 2, kS>,
                               ready_refine<2, kS>(), W,
                               refine_smem<double>(n, 2, true), blocks);
      });
    case 7:
      return factor_occupancy<double, 1>(n, blocks, threads);
    case 8:
      return one ? shared_solve_occupancy<double, 1>(n, blocks, threads)
                 : shared_solve_occupancy<double, 2>(n, blocks, threads);
    case 9:
      return factor_occupancy<float, 1>(n, blocks, threads);
    case 10:
      return shared_solve_occupancy<float, 1>(n, blocks, threads);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
