// Device routines shared by the f64 KKT kernels (ldl.cu) and the f32
// batched LDL^T kernels (ldl_f32.cu), templated on the scalar type.
//
// One thread block works on one problem.  Matrices come in row-major
// (N, N) per problem, N <= kMaxN, and live in shared memory as packed
// lower triangles: row i holds columns 0..i at offset tri(i).  None of
// these routines synchronises on entry; each says what it needs.

#pragma once

#include <cuda_runtime.h>

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

// In-place solve (I + L) D (I + L)^T x = b for R right-hand sides.
// ls: packed strict-lower unit factor L (its diagonal is not read),
// dinv: D^-1, x: (n, R) in shared memory, holding b on entry.  The
// caller syncs before the call; the routine returns synced.
template <class T, int R>
__device__ void ldl_solve_smem(const T* ls, const T* dinv, T* x, int n) {
  // forward, column by column: after step j-1, x_j is final
  for (int j = 0; j + 1 < n; ++j) {
    for (int i = j + 1 + threadIdx.x; i < n; i += blockDim.x) {
      const T l = ls[tri(i) + j];
#pragma unroll
      for (int t = 0; t < R; ++t) x[i * R + t] -= l * x[j * R + t];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int t = 0; t < R; ++t) x[i * R + t] *= dinv[i];
  }
  __syncthreads();
  // backward, row by row of L: x_j -= L_ij x_i for j < i
  for (int i = n - 1; i > 0; --i) {
    const T* row = ls + tri(i);
    for (int j = threadIdx.x; j < i; j += blockDim.x) {
      const T l = row[j];
#pragma unroll
      for (int t = 0; t < R; ++t) x[j * R + t] -= l * x[i * R + t];
    }
    __syncthreads();
  }
}

}  // namespace
