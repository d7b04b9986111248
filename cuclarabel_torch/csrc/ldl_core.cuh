// Device routines shared by the f64 KKT kernels (ldl.cu) and the f32
// batched LDL^T kernels (ldl_f32.cu), templated on the scalar type.
//
// One thread block works on one problem: the factors with four warps
// that share each panel's trailing update, the substitutions with one
// warp.  Matrices come in row-major (N, N) per problem, N <= kMaxN, and
// live in shared memory as lower triangles: packed by rows for the
// substitutions (row i holds columns 0..i at offset tri(i)), in 4 x 4
// blocks for the factor (FactorLayout).  None of these routines
// synchronises on entry; each says what it needs.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxN = 128;

// Offset of row i of a packed lower triangle (row i holds columns 0..i).
__host__ __device__ inline int tri(int i) { return i * (i + 1) / 2; }

// ---------------------------------------------------------------------
// One warp per problem: the substitution of ldl_solve (f64) and
// ldl_solve_batched (f32), and the solves of ldl_solve_refine.
//
// Lane l owns rows l + 32 q, q < S, of the right-hand sides, in
// registers (slot q holds row 32 q + l); S = ceil(N / 32), a template
// argument, so no lane computes a slot that holds no row.  Each of the
// 2 (N - 1) sequential steps of a substitution broadcasts the final x_j from
// its lane with a shuffle, and every lane applies it to its own rows:
// no block barrier, no shared-memory round trip for x.  The factor is a
// packed triangle in shared memory, row i at tri(i): the forward sweep
// reads a column (lanes on rows tri(i) + j), the backward sweep a row
// (lanes on consecutive columns).  tri(i) mod 16 runs through all 16
// residues over each aligned run of 16 rows, so both reads are free of
// bank conflicts for 8-byte words (and tri(i) mod 32 over 32 rows for
// 4-byte ones).
// ---------------------------------------------------------------------
constexpr int kWarp = 32;
// A block of the one-warp kernels has kLoadWarps warps: all of them copy
// the problem's triangles into shared memory, then warp 0 alone solves
// (one warp alone keeps too few copies in flight: ldl_solve at
// (76, 1) took 17.8 us with one warp copying and 12.7 us with four, on
// an H100 80GB HBM3 at 700 W).
constexpr int kLoadWarps = 4;
constexpr int kLoadThreads = kWarp * kLoadWarps;
constexpr unsigned kFullMask = 0xffffffffu;

// The slots S a lane needs at N: ceil(N / 32), 1..4 for N <= kMaxN.
__host__ __device__ inline int slots(int n) { return (n + kWarp - 1) / kWarp; }

// f(std::integral_constant<int, S>{}) for S = slots(n): the one-warp
// kernels are instantiated per slot count, so that a lane computes no
// slot that holds no row.
template <class F>
inline int with_slots(int n, F&& f) {
  switch (slots(n)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return f(std::integral_constant<int, 4>{});
  }
}

// Copy sizeof(T) bytes from device memory to the shared-memory address
// `sa` asynchronously (cp.async); 4 and 8 bytes need only the element's
// own alignment, so any N and any row offset will do.
template <class T>
__device__ inline void cp_async(unsigned sa, const T* g) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte words");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa),
               "l"(g), "n"(sizeof(T)));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most `Pending` of this thread's committed groups are
// still in flight; the caller then synchronises with the other copying
// threads to see their copies.
template <int Pending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Named barrier 1 over the whole block: the loading warps arrive, warp 0
// waits for them.
__device__ inline void loaders_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"r"(blockDim.x) : "memory");
}
__device__ inline void wait_for_loaders() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(blockDim.x) : "memory");
}

// Row and column of element e of a packed lower triangle (row i holds
// columns 0..i from e = tri(i)): i from a float square root, corrected
// by one step either way, so exact for every e below tri(kMaxN).
__device__ inline void tri_index(int e, int& i, int& k) {
  i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  i += tri(i + 1) <= e ? 1 : 0;
  i -= tri(i) > e ? 1 : 0;
  k = e - tri(i);
}

// Request, with all the block's threads, the lower triangle of the
// row-major (N, N) matrix g (the diagonal too if `diag`) into the packed
// triangle s, row i at tri(i) (the diagonal slot left unwritten without
// `diag`).  The triangle is walked as one flat sequence, blockDim.x
// consecutive elements per round (neighbouring threads on neighbouring
// columns of a row: coalesced), each thread finding its element's row
// and column by tri_index: no loop that diverges, and every copy in
// flight at once.  Commits nothing and waits for nothing.
template <class T>
__device__ void load_lower_async(const T* __restrict__ g, T* s, int n,
                                 bool diag) {
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(s));
  // the strict triangle's rows 1..n-1 have the lengths 1..n-1 of the
  // full triangle of order n - 1: its row r is row r + 1
  const int total = diag ? tri(n) : tri(n - 1);
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int i, k;
    tri_index(e, i, k);
    i += 1 - (diag ? 1 : 0);
    cp_async(s0 + sizeof(T) * (tri(i) + k), g + (size_t)i * n + k);
  }
}

// Rotate the lane's rows one slot down (a[q] <- a[q + 1], a[S - 1] <-
// a[0]) or up: register moves that let a runtime loop over panels keep its
// panel in slot 0, with every slot index a compile-time constant.
template <class T, int R, int S>
__device__ inline void rotate_down(T (&a)[S][R]) {
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const T first = a[0][t];
#pragma unroll
    for (int q = 0; q + 1 < S; ++q) a[q][t] = a[q + 1][t];
    a[S - 1][t] = first;
  }
}
template <class T, int R, int S>
__device__ inline void rotate_up(T (&a)[S][R]) {
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const T last = a[S - 1][t];
#pragma unroll
    for (int q = S - 1; q > 0; --q) a[q][t] = a[q - 1][t];
    a[0][t] = last;
  }
}

// x := ((I + L) D (I + L)^T)^-1 x for R right-hand sides, by the calling
// warp.  ls: the packed strict-lower unit factor (row i at tri(i), the
// diagonal not read); dinv and x: the lane's rows (slot q = row
// 32 q + lane; rows >= n are neither read nor written).  Each x_i takes
// its updates in the order of the plain version (kkt/ldl.py::_solve):
// forward in ascending j, then D^-1, backward in descending i, each a
// multiply then a subtract, so with -fmad=false the two agree bit for
// bit.
//
// Each sweep walks the four 32-row panels in a runtime loop, the
// current panel rotated into slot 0 (four rotations in all, so x ends
// as it began): one copy of the step code, small enough for the
// instruction cache, which fully unrolled copies per panel and per call
// overran.  Within a panel the steps go in chunks of kChunk: the chunk's
// factor entries are all loaded into registers first, behind a
// __syncwarp() that no load moves past (left alone, the compiler puts
// each load just before its use, and a warp that issues in order then
// waits out one load latency per slot and step); the chunk's steps then
// run on registers: a shuffle, the multiplies, the subtracts.  Every
// lane loads (from an index clamped into the triangle) and computes, and
// a select keeps or drops the result: the warp never diverges inside a
// chunk.
//
// `wait(p)` runs before the forward sweep reads panel p's columns
// (entries (i, j), 32 p <= j < 32 p + 32, of every row i > j): a caller
// whose triangle is still arriving waits there for that panel's copy
// (ldl_wide.cu's shared substitution); NoWait, the default, does nothing.
constexpr int kChunk = 4;

struct NoWait {
  __device__ void operator()(int) const {}
};

template <class T, int R, int S, class Wait = NoWait>
__device__ void warp_solve(const T* ls, const T (&dinv)[S],
                           T (&x)[S][R], int n, Wait wait = Wait()) {
  const int lane = threadIdx.x & 31;

  // forward: x_i -= L_ij x_j for i > j; x_j is final when step j starts.
  // Panel p in slot 0; slot q holds panel (p + q) mod 4.
#pragma unroll 1
  for (int p = 0; p < S; ++p) {
    wait(p);
    int row[S], off[S];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      row[q] = kWarp * (p + q < S ? p + q : p + q - S) + lane;
      off[q] = row[q] < n ? tri(row[q]) : 0;
    }
    const int steps = min(kWarp, n - 1 - kWarp * p);  // may be <= 0
#pragma unroll 1
    for (int c = 0; c < steps; c += kChunk) {
      T l[kChunk][S];  // L_ij, j = 32 p + c + s, i = row[q]
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const int j = min(kWarp * p + c + s, n - 1);
#pragma unroll
        for (int q = 0; q < S; ++q) l[s][q] = ls[off[q] + j];
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const int j = kWarp * p + c + s;
        const bool step = c + s < steps;
        T xj[R];
#pragma unroll
        for (int t = 0; t < R; ++t)
          xj[t] = __shfl_sync(kFullMask, x[0][t], (c + s) & 31);
#pragma unroll
        for (int q = 0; q < S; ++q) {
          const bool on = step && row[q] > j && row[q] < n;
#pragma unroll
          for (int t = 0; t < R; ++t) {
            const T v = x[q][t] - l[s][q] * xj[t];
            x[q][t] = on ? v : x[q][t];
          }
        }
      }
    }
    rotate_down(x);
  }
#pragma unroll
  for (int q = 0; q < S; ++q) {
    if (kWarp * q + lane < n) {
#pragma unroll
      for (int t = 0; t < R; ++t) x[q][t] *= dinv[q];
    }
  }
  // backward: x_j -= L_ij x_i for j < i; x_i is final when step i starts.
  // Panel p in slot 0 again, slot q holding panel (p + q) mod 4; row i's
  // entries for the lane's columns j are read at min(j, i), in range of
  // the triangle.
  rotate_up(x);
#pragma unroll 1
  for (int p = S - 1; p >= 0; --p) {
    int col[S];
#pragma unroll
    for (int q = 0; q < S; ++q)
      col[q] = kWarp * (p + q < S ? p + q : p + q - S) + lane;
    const int rows = min(kWarp, n - kWarp * p);  // may be <= 0
    const int steps = rows - (p == 0 ? 1 : 0);  // step i = 0 does nothing
#pragma unroll 1
    for (int c = 0; c < steps; c += kChunk) {
      T l[kChunk][S];  // L_ij, i = 32 p + rows - 1 - c - s, j = col[q]
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const int i = max(kWarp * p + rows - 1 - c - s, 0);
        const T* row = ls + tri(i);
#pragma unroll
        for (int q = 0; q < S; ++q) l[s][q] = row[min(col[q], i)];
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const int ii = rows - 1 - c - s;
        const int i = kWarp * p + ii;
        const bool step = c + s < steps;
        T xi[R];
#pragma unroll
        for (int t = 0; t < R; ++t)
          xi[t] = __shfl_sync(kFullMask, x[0][t], ii & 31);
#pragma unroll
        for (int q = 0; q < S; ++q) {
          const bool on = step && col[q] < i;
#pragma unroll
          for (int t = 0; t < R; ++t) {
            const T v = x[q][t] - l[s][q] * xi[t];
            x[q][t] = on ? v : x[q][t];
          }
        }
      }
    }
    rotate_up(x);
  }
  rotate_down(x);  // five rotations up in all: one down restores x
}

// Load the lane's rows of a (B, N, R) right-hand side (rows >= n: 0).
template <class T, int R, int S>
__device__ void load_rows(const T* __restrict__ g, T (&v)[S][R],
                          int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int i = kWarp * q + lane;
#pragma unroll
    for (int t = 0; t < R; ++t) v[q][t] = i < n ? g[i * R + t] : T(0);
  }
}

// D^-1 of the lane's rows (rows >= n: 0).
template <class T, int S>
__device__ void load_dinv(const T* __restrict__ g, T (&d)[S], int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int i = kWarp * q + lane;
    d[q] = i < n ? g[i] : T(0);
  }
}

// Store the lane's rows of a (B, N, R) result.
template <class T, int R, int S>
__device__ void store_rows(const T (&v)[S][R], T* __restrict__ g,
                           int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int i = kWarp * q + lane;
    if (i < n) {
#pragma unroll
      for (int t = 0; t < R; ++t) g[i * R + t] = v[q][t];
    }
  }
}

// ---------------------------------------------------------------------
// The blocked pivot-free LDL^T factor of ldl_factor (f64) and
// ldl_factor_batched (f32): K + diag(reg) = (I + L) D (I + L)^T.
//
// Right-looking, in panels of kPanel pivots, by the block's four warps.
// For each panel j0:
//  (a) the strip, rows >= j0 of columns j0 .. j0 + 7, is factored in
//      registers by as many warps as it has 32-row slots, pivot by
//      pivot: D^-1 = 1 / a_jj, l_ij = a_ij * D^-1, the strip's later
//      columns updated.  Each strip warp factors the panel's own 8 rows
//      itself (factor_strip), so the warps exchange nothing; they write
//      D^-1, L into the triangle, and each pivot's unscaled column a_ij
//      and scaled column l_kj into two panel buffers;
//  (b) one block barrier;
//  (c) every thread updates the trailing triangle, columns >= j0 + 8,
//      one 4 x 4 register tile at a time, tiles dealt out afresh each
//      panel as the triangle shrinks: the tile is loaded once, takes the
//      panel's 8 updates a_ik -= a_ij * l_kj in pivot order, each a
//      multiply then a subtract, and is stored once;
//  (d) one block barrier.
// So every element receives the subtractions of the plain version
// (kkt/ldl.py::_factor), in its order and with its rounding (the
// kernels build with -fmad=false): the two agree bit for bit.  2 N / 8
// barriers in place of 2 N, and per update 2 / 8 shared accesses for the
// tile plus 8 / 16 for the panel columns, in place of 3.
// The strips take the most time at every width: each pivot waits on a
// shuffle, a divide and a multiply, in every strip warp.
//
// Layout (FactorLayout): the lower triangle in 4 x 4 blocks, block
// (I, K), K <= I, numbered tri(I) + K; element (i, k) lives in array
// (i % 4) * 4 + k % 4 at the block's number, each of the 16 arrays ntp
// elements long.  Threads on consecutive tiles of a block row read
// consecutive words of each array, free of bank conflicts; ntp * sizeof(T)
// is 32 mod M bytes (M = 128 here, 64 in the wide factor: either puts
// the four arrays that a row-wise access touches on distinct banks), so
// that the 16 lanes (f64) or 32 lanes (f32) of a row-wise access -- the
// copy of K, the store of L -- fall on distinct banks too.  The panel
// buffers hold row i of pivot p at (p * 4 + i % 4) * nbp + i / 4, nbp
// padded as ntp: a tile's four column entries are consecutive words
// across threads, its four row entries one broadcast.
// Slots outside the triangle (above the diagonal of a diagonal block,
// rows >= n) hold junk that flows only into such slots.
//
// factor_blocked takes the block's threads (kThreads, at least one per
// row and one warp per 32-row slot of the first strip) and the largest
// N (kRows) as template arguments: 128 and 128 here, larger in the wide
// factor of ldl_wide.cu.
// ---------------------------------------------------------------------
constexpr int kPanel = 8;
constexpr int kFactorThreads = 128;

// The least count >= c of T whose bytes are 32 mod M.
template <class T, int M = 128>
__host__ __device__ inline int bank_pad(int c) {
  constexpr int m = M / sizeof(T), r = 32 / sizeof(T);
  return c + ((r - c % m) % m + m) % m;
}

template <class T, int M = 128>
struct FactorLayout {
  int n, nb, ntp, nbp;
  int ba, bl, dinv, sink;  // offsets of the panel buffers, D^-1, the sink
  __host__ __device__ explicit FactorLayout(int n_)
      : n(n_), nb((n_ + 3) / 4), ntp(bank_pad<T, M>(tri((n_ + 3) / 4))),
        nbp(bank_pad<T, M>((n_ + 3) / 4)), ba(16 * ntp),
        bl(ba + kPanel * 4 * nbp), dinv(bl + kPanel * 4 * nbp),
        sink(dinv + n_) {}
  // element (i, k) of the triangle
  __device__ int at(int i, int k) const {
    return ((i & 3) * 4 + (k & 3)) * ntp + tri(i >> 2) + (k >> 2);
  }
  // row i of pivot p in a panel buffer, from the buffer's offset
  __device__ int buf(int p, int i) const {
    return (p * 4 + (i & 3)) * nbp + (i >> 2);
  }
  // the triangle, the two panel buffers, D^-1 and a slot per lane that
  // takes the stores a lane makes of nothing, in elements
  __host__ __device__ int smem() const { return sink + kWarp; }
};

// Request the lower triangle of the row-major (N, N) matrix g into the
// blocked triangle a with cp.async, one warp per row, lanes on
// consecutive columns (coalesced, and free of bank conflicts).  Commits
// nothing and waits for nothing.
template <class T, int M>
__device__ void load_factor_input(const T* __restrict__ g, T* a,
                                  const FactorLayout<T, M>& f) {
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(a));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < f.n; i += nw) {
    const T* row = g + (size_t)i * f.n;
    for (int k = lane; k <= i; k += kWarp)
      cp_async(s0 + sizeof(T) * f.at(i, k), row + k);
  }
}

// Named barrier 2 over the strip warps (`warps` of them): each has read
// the panel's head rows before warp 0 writes L over them.
__device__ inline void strip_warps_sync(int warps) {
  asm volatile("bar.sync 2, %0;\n" ::"r"(warps * kWarp) : "memory");
}

// The first of the warps that factor the strips: rotated over the
// block's kWarps warps from block to block, so that the strips of the
// blocks resident on an SM are spread over its four schedulers.
template <int kWarps = kFactorThreads / kWarp>
__device__ inline int strip_warp() {
  return blockIdx.x % kWarps;
}

// (a): strip warp w (w = 0, 1, ... from strip_warp()) factors rows
// j0 + 32 w .. j0 + 32 w + 31 of the strip of panel j0 (columns j0 ..
// j0 + 7).  Its slot 0 holds the panel's head, rows j0 + lane, so that
// every strip warp factors the panel's own rows itself (warp 0 for its
// stores, the others redundantly, with the same operations): D^-1 and
// l_cj come from its own lanes and no warp waits on another.  S = 1 for
// warp 0; S = 2 for the others, slot 1 holding their own rows.  The
// entries are indexed by compile-time constants only (the pivots
// unrolled).  For each pivot every shuffle of l_cj is requested before
// the updates, so that all of them wait on the shuffles together; the
// next pivot's a_jj is computed in its own lane from its own l, off the
// shuffles' path, with the operations of the general update.  No branch
// between the pivots: every store is unconditional, a lane that stores
// nothing writing its sink slot (D^-1 too, kept in shared memory until
// the end), and pivots j >= n run on junk.  An entry above the diagonal
// or of a row >= n is junk that reaches only junk.  `warps` strip warps
// take part.  A pivot that cancels to exactly zero takes its row's
// regularization reg[j] instead (reg nullptr: it stays zero); lane p
// holds reg[j0 + p] and substitutes it in its own lane, before the
// pivot's shuffle.  The guard goes beyond the reference's factor, which
// has none: its double-float rounding leaves such a pivot a tiny nonzero
// (a very large D^-1, not 1 / reg[j]), where f64 gives exactly zero and
// D^-1 = inf, which fails the solve.  Only an exact zero is replaced.
// Returns `finite` and whether every D^-1 of the panel is finite, in
// every lane.
template <class T, int S, int M>
__device__ bool factor_strip(T* sm, const FactorLayout<T, M>& f,
                             const T* __restrict__ reg, int j0, int w,
                             int warps, bool finite) {
  const int lane = threadIdx.x & 31;
  const int n = f.n, t0 = j0 + kPanel, sink = f.sink + lane;
  const T rj = reg != nullptr && j0 + lane < n ? reg[j0 + lane] : T(0);
  int row[S];  // the slots' rows
  bool own[S];  // whether this warp stores the slot
  row[0] = j0 + lane;
  own[0] = w == 0;
  if constexpr (S == 2) {
    row[1] = j0 + kWarp * w + lane;
    own[1] = true;
  }
  T s[S][kPanel];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int i = row[q];
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      s[q][c] = i < n && j0 + c <= i ? sm[f.at(i, j0 + c)] : T(0);
  }
  if (warps > 1) strip_warps_sync(warps);
  T ajj = s[0][0];  // in lane p at pivot p: the pivot
#pragma unroll
  for (int p = 0; p < kPanel; ++p) {
    const int j = j0 + p;
    const T dj = T(1) / __shfl_sync(kFullMask, ajj == T(0) ? rj : ajj, p);
    sm[own[0] && j < n && lane == 0 ? f.dinv + j : sink] = dj;
    finite = finite && (j >= n || isfinite(dj));
    T lv[S];
#pragma unroll
    for (int q = 0; q < S; ++q) lv[q] = s[q][p] * dj;
    T lc[kPanel];
#pragma unroll
    for (int c = p + 1; c < kPanel; ++c)
      lc[c] = __shfl_sync(kFullMask, lv[0], c);
    if (p + 1 < kPanel) ajj = s[0][p + 1] - s[0][p] * lv[0];
    // the strip's later columns: a_ic -= a_ij * l_cj
#pragma unroll
    for (int c = p + 1; c < kPanel; ++c)
#pragma unroll
      for (int q = 0; q < S; ++q) s[q][c] = s[q][c] - s[q][p] * lc[c];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int i = row[q];
      const bool low = own[q] && i > j && i < n, trail = low && i >= t0;
      sm[low ? f.at(i, j) : sink] = lv[q];
      sm[trail ? f.ba + f.buf(p, i) : sink] = s[q][p];
      sm[trail ? f.bl + f.buf(p, i) : sink] = lv[q];
    }
  }
  return finite;
}

// (c): the trailing triangle, block rows and columns >= t0 / 4, one 4 x 4
// tile per thread and round.  The next pivot's panel entries are loaded
// while the current pivot's updates run.
template <class T, int M>
__device__ void factor_trailing(T* a, const FactorLayout<T, M>& f, int t0) {
  const T* ba = a + f.ba;
  const T* bl = a + f.bl;
  const int b0 = t0 >> 2;
  const int tiles = tri(f.nb - b0);
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    int I, K;
    tri_index(t, I, K);
    I += b0;
    K += b0;
    T* tile = a + tri(I) + K;
    T v[4][4], av[2][4], lv[2][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      av[0][r] = ba[r * f.nbp + I];
      lv[0][r] = bl[r * f.nbp + K];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[r][c] = tile[(r * 4 + c) * f.ntp];
#pragma unroll
    for (int p = 0; p < kPanel; ++p) {
      const int cur = p & 1, nxt = cur ^ 1;
      if (p + 1 < kPanel) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          av[nxt][r] = ba[((p + 1) * 4 + r) * f.nbp + I];
          lv[nxt][r] = bl[((p + 1) * 4 + r) * f.nbp + K];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[r][c] = v[r][c] - av[cur][r] * lv[cur][c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) tile[(r * 4 + c) * f.ntp] = v[r][c];
  }
}

template <class T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

// Write the strict lower part of the blocked triangle to the row-major
// (N, N) matrix g, zeros on and above the diagonal, coalesced by rows:
// W columns per lane and store (W = 2 at even N: 16 bytes in f64), two
// rows at a time per warp, every shared load of both rows issued before
// their stores.
// W consecutive values as one store.
template <class T>
__device__ inline T pack(const T (&v)[1]) { return v[0]; }
template <class T>
__device__ inline typename Pair<T>::type pack(const T (&v)[2]) {
  typename Pair<T>::type p;
  p.x = v[0];
  p.y = v[1];
  return p;
}

template <class T, int W, int kRows, int M>
__device__ void store_factor_rows(const T* a, T* __restrict__ g,
                                  const FactorLayout<T, M>& f) {
  constexpr int kIts = kRows / (kWarp * W);  // column steps to cover a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int n = f.n;
  for (int i0 = warp; i0 < n; i0 += 2 * nw) {
    T v[2][kIts][W];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h * nw;
#pragma unroll
      for (int it = 0; it < kIts; ++it)
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int k = W * (lane + kWarp * it) + w;
          v[h][it][w] = i < n && k < i ? a[f.at(i, k)] : T(0);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h * nw;
#pragma unroll
      for (int it = 0; it < kIts; ++it) {
        const int k = W * (lane + kWarp * it);
        if (i < n && k < n)
          *reinterpret_cast<decltype(pack(v[h][it]))*>(g + (size_t)i * n + k) =
              pack(v[h][it]);
      }
    }
  }
}

template <class T, int kRows, int M>
__device__ void store_factor(const T* a, T* __restrict__ g,
                             const FactorLayout<T, M>& f) {
  if (f.n % 2 == 0)
    store_factor_rows<T, 2, kRows>(a, g, f);
  else
    store_factor_rows<T, 1, kRows>(a, g, f);
}

// The whole factor of one problem by the calling block (kThreads
// threads, at least one per row, N <= kRows): K (N, N) row-major, of
// which the lower triangle is read; reg (N) or nullptr; L (N, N) and
// dinv (N) written.  smem holds FactorLayout<T, M>(n).smem() elements.
// Returns, in the lanes of strip_warp<kThreads / 32>(), whether every
// D^-1 is finite.
template <class T, int kThreads = kFactorThreads, int kRows = kMaxN,
          int M = 128>
__device__ bool factor_blocked(const T* __restrict__ K,
                               const T* __restrict__ reg, T* __restrict__ L,
                               T* __restrict__ dinv, T* smem, int n) {
  static_assert(kThreads >= kRows, "a thread per row for reg");
  static_assert(kRows % (2 * kWarp) == 0, "whole column steps of a row");
  const FactorLayout<T, M> f(n);
  T* a = smem;
  constexpr int kWarps = kThreads / kWarp;
  // this warp's rank among the strip warps
  const int w =
      ((threadIdx.x >> 5) - strip_warp<kWarps>() + kWarps) % kWarps;
  const int i = threadIdx.x;
  load_factor_input(K, a, f);
  cp_async_commit();
  const T ri = reg != nullptr && i < n ? reg[i] : T(0);  // while K arrives
  cp_async_wait<0>();
  __syncthreads();
  if (reg != nullptr && i < n) a[f.at(i, i)] += ri;  // K + diag(reg)
  __syncthreads();
  bool finite = true;
#pragma unroll 1
  for (int j0 = 0; j0 < n; j0 += kPanel) {
    const int warps = slots(n - j0);
    if (w == 0)
      finite = factor_strip<T, 1>(a, f, reg, j0, 0, warps, finite);
    else if (w < warps)
      factor_strip<T, 2>(a, f, reg, j0, w, warps, finite);
    __syncthreads();
    if (j0 + kPanel < n) {
      factor_trailing(a, f, j0 + kPanel);
      __syncthreads();
    }
  }
  store_factor<T, kRows>(a, L, f);
  for (int k = threadIdx.x; k < n; k += blockDim.x) dinv[k] = a[f.dinv + k];
  return finite;
}

// Raise a kernel's dynamic shared memory cap to `bytes` (what N = kMaxN
// needs), once per kernel and device: the attribute belongs to the
// current device's context, and above 48 KB a launch (and an occupancy
// query) needs it.
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

}  // namespace
