// Segment sums in one fixed order for NVIDIA Hopper (sm_90a): the entry
// point cones/segsum.py::segment_sum.
//
// Replaces the reference's per-cone reductions of the second-order cones
// (cuclarabel_tpu/cones/ops.py::_seg_sum, jax.ops.segment_sum over the
// gathered vector) and the equilibration's rectification means.  On the
// card an `index_add_` over segment ids adds a repeated target with
// atomics, in an order that changes from run to run, so that two solves
// of one batch differ in their last bits; here every sum runs in one
// order, the order `index_add_` takes on the CPU: out[b, s] = 0, then
// out[b, s] += vals[b, idx[s, k]] for k ascending, entries with
// idx[s, k] < 0 left out.  The kernel and its plain version
// (segsum.py::segment_sum_plain, `index_add_` on the CPU) agree bit for
// bit, and a problem's sums do not depend on the batch it lies in.
//
// One thread per (problem, segment), problem-major, so that the threads
// of a warp read neighbouring entries of one problem's row; a grid-stride
// loop covers any B.  Segments are a few to a few hundred entries: the
// kernel reads each entry of the batch once and is bound by its bytes.
//
// Host interface: plain C functions returning cudaGetLastError() after
// the launch, called through ctypes, on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kSegThreads = 256;
// a grid of at most this many blocks strides over the batch
constexpr int kSegMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kSegThreads)
    segment_sum_kernel(const double* __restrict__ vals,
                       const int* __restrict__ idx, double* __restrict__ out,
                       int B, int m, int nseg, int width) {
  const long long total = (long long)B * nseg;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(t / nseg);
    const int s = (int)(t - (long long)b * nseg);
    const int* row = idx + (size_t)s * width;
    const double* v = vals + (size_t)b * m;
    double acc = 0.0;
    for (int k = 0; k < width; ++k) {
      const int j = row[k];
      if (j >= 0) acc = acc + v[j];
    }
    out[t] = acc;
  }
}

}  // namespace

extern "C" {

// vals (B, m) row-major, idx (nseg, width) int32 with -1 for padding,
// out (B, nseg).
int cc_segment_sum(const double* vals, const int* idx, double* out, int B,
                   int m, int nseg, int width, void* stream) {
  if (B < 0 || m < 0 || nseg < 0 || width < 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * nseg;
  if (total == 0) return 0;
  const long long want = (total + kSegThreads - 1) / kSegThreads;
  const int blocks = (int)(want < kSegMaxBlocks ? want : kSegMaxBlocks);
  segment_sum_kernel<<<blocks, kSegThreads, 0, (cudaStream_t)stream>>>(
      vals, idx, out, B, m, nseg, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
