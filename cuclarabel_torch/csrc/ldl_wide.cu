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
//   ldl_solve_refine_wide_kernel<double, R, S>  K2w / K2rw: _refine_impl,
//                                      _refine_impl_r (S > 0: L in shared
//                                      memory, up to N = 233 / 226)
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
// block takes one problem.  The factor and the substitution keep only
// vectors and one panel in shared memory and read the triangles from
// device memory, where a problem's rows stay in the L2 while its block
// works on them.  The residual reads K's lower triangle once, in 32 x 32
// tiles held in registers (block_residual); the refined solve copies L
// into shared memory once where it fits, sweeps there in one warp, and
// runs its residuals through the same body.  The kernels take any N
// whose panel buffers fit in shared memory (the factor's 16 N words:
// N <= ~1,800 in f64), with size_t offsets; the refined solve's shared
// form N from 129 to its fit.
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
// ldl_solve_wide: x = ((I + L) D (I + L)^T)^-1 b, b in shared memory for
// the sweeps, L read from device memory.  Bound: L's strict triangle,
// D^-1, b and x: 0.37 GB at (148, 4096), 0.11 ms.
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
// to 256): the instantiations of the shared form, launched only where
// refine_form picks it (N <= 233 at R = 1, 226 at R = 2 on an H100); an
// N outside them returns cudaErrorInvalidValue.
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
size_t vector_smem(int n, int r) { return sizeof(T) * (size_t)n * r; }
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

// The form of the wide refined solve at (n, r) on the current device: 1
// (L in shared memory) where S = slots(n) has an instantiation and
// refine_smem fits what one block may opt into, 0 (streaming) above; a
// negative CUDA error where the device cannot be asked.
int refine_form(int n, int r) {
  int dev = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -(int)e;
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
template <int R, int S>
cudaError_t ready_refine() {
  static DeviceFlags done = {};
  return allow_all_smem(ldl_solve_refine_wide_kernel<double, R, S>, done);
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

// 1 where the wide refined solve keeps L in shared memory at (n, r) on
// the current device, 0 where it streams L; a negative CUDA error.
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

// Resident blocks per SM and threads per block of one wide kernel's
// launch at N = n, R = r on the current device.  kernel: 0 ldl_factor,
// 1 ldl_solve, 2 kkt_residual, 3 ldl_solve_refine (streaming), 6
// ldl_solve_refine (L in shared memory) (f64), 4 ldl_factor_batched, 5
// ldl_solve_batched (f32).
int cc_occupancy_wide(int kernel, int n, int r, int* blocks, int* threads) {
  if (bad_shape(1, n, r)) return (int)cudaErrorInvalidValue;
  const int W = kWideThreads, RW = kResWarps * kWarp;
  *threads = kernel == 2 ? RW : W;
  const bool one = r == 1;
  switch (kernel) {
    case 0:
      return occupancy(ldl_factor_wide_kernel<double>,
                       ready_factor<double>(), W, factor_smem<double>(n),
                       blocks);
    case 1:
      return one ? occupancy(ldl_solve_wide_kernel<double, 1>,
                             ready_solve<double, 1>(), W,
                             vector_smem<double>(n, 1), blocks)
                 : occupancy(ldl_solve_wide_kernel<double, 2>,
                             ready_solve<double, 2>(), W,
                             vector_smem<double>(n, 2), blocks);
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
    case 4:
      return occupancy(ldl_factor_wide_kernel<float>, ready_factor<float>(),
                       W, factor_smem<float>(n), blocks);
    case 5:
      return occupancy(ldl_solve_wide_kernel<float, 1>,
                       ready_solve<float, 1>(), W, vector_smem<float>(n, 1),
                       blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
