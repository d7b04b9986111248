// Device routines shared by the f64 KKT kernels (ldl.cu) and the f32
// batched LDL^T kernels (ldl_f32.cu), templated on the scalar type.
//
// One thread block works on one problem: the factors with 256 threads,
// the substitutions with one warp.  Matrices come in row-major (N, N)
// per problem, N <= kMaxN, and live in shared memory as packed lower
// triangles: row i holds columns 0..i at offset tri(i).  None of these
// routines synchronises on entry; each says what it needs.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxN = 128;

// Offset of row i of a packed lower triangle (row i holds columns 0..i).
__host__ __device__ inline int tri(int i) { return i * (i + 1) / 2; }

// Copy the lower triangle (diagonal included) of a row-major (N, N)
// matrix in device memory into a packed triangle in shared memory.  One
// warp per row, lanes over consecutive columns: coalesced reads.
template <class T>
__device__ void load_lower_packed(const T* __restrict__ g, T* s, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < n; i += nw) {
    const T* row = g + (size_t)i * n;
    T* srow = s + tri(i);
    for (int k = lane; k <= i; k += 32) srow[k] = row[k];
  }
}

// Pivot-free LDL^T of the packed lower triangle `a` in place: on return
// its strict lower part holds L (unit diagonal implied), and dinv[j] =
// 1 / D_j has been written to device memory.  acol and lcol are n
// entries of shared scratch each.  Each pivot step scales the pivot
// column, then applies the rank-1 update to the trailing lower triangle
// with one warp per row: a_ik -= a_ij * (a_kj / a_jj), the rounding of
// the plain PyTorch versions.  The caller syncs before the call; the
// routine returns synced.  Returns (in thread 0) whether every D^-1 is
// finite.
template <class T>
__device__ bool factor_packed(T* a, T* acol, T* lcol, T* __restrict__ dinv,
                              int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  bool finite = true;
  for (int j = 0; j < n; ++j) {
    const T dj = T(1) / a[tri(j) + j];
    for (int k = j + 1 + threadIdx.x; k < n; k += blockDim.x) {
      const T v = a[tri(k) + j];
      const T l = v * dj;
      acol[k] = v;
      lcol[k] = l;
      a[tri(k) + j] = l;
    }
    if (threadIdx.x == 0) {
      dinv[j] = dj;
      finite = finite && isfinite(dj);
    }
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += nw) {
      const T ai = acol[i];
      T* row = a + tri(i);
      for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= ai * lcol[k];
    }
    __syncthreads();
  }
  return finite;
}

// Write the strict lower part of the packed triangle `a` to a row-major
// (N, N) matrix in device memory, zeros on and above the diagonal, so
// the tensor holds no junk.  Coalesced by rows.
template <class T>
__device__ void store_strict_lower(const T* a, T* __restrict__ g, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < n; i += nw) {
    const T* srow = a + tri(i);
    for (int k = lane; k < n; k += 32)
      g[(size_t)i * n + k] = k < i ? srow[k] : T(0);
  }
}

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
inline int slots(int n) { return (n + kWarp - 1) / kWarp; }

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
constexpr int kChunk = 4;

template <class T, int R, int S>
__device__ void warp_solve(const T* ls, const T (&dinv)[S],
                           T (&x)[S][R], int n) {
  const int lane = threadIdx.x & 31;

  // forward: x_i -= L_ij x_j for i > j; x_j is final when step j starts.
  // Panel p in slot 0; slot q holds panel (p + q) mod 4.
#pragma unroll 1
  for (int p = 0; p < S; ++p) {
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

}  // namespace
