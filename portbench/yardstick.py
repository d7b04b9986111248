"""The benchmark's frozen measures: peaks, a kernel's bytes and
operations, the union of device intervals, and the percentile.

These are copies, kept here so that a change to the program cannot move
the yardstick it is measured with.  `work` is a copy of
`cuclarabel_torch/kernel_timing.py::work`, `union_seconds` of the union
arithmetic of `cuclarabel_torch/profiling.py::busy_ms`.  The peaks are
the H100 SXM data sheet's: 3.35 TB/s of HBM3 and 67 TFLOP/s in f64 on
the tensor cores, a multiply-add counted as two operations, as `work`
counts each multiply and each add.  No kernel, however it is built, can
beat that bound.
"""

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOP_PER_S = 67e12


def work(name, B, N, R=1, npass=1):
    """(bytes, operations) that one call of the LDL^T function `name`
    at (B, N, R, npass) must move and do: each input read once and each
    output written once, K and L counted as the triangles the function
    needs (K is symmetric, and L is strictly lower).  f64 operands.
    Names: ldl_factor, ldl_solve, kkt_residual, ldl_solve_refine."""
    f8 = 8
    tri = N * (N + 1) // 2
    stri = N * (N - 1) // 2
    solve_ops = 2 * stri * 2 * R + N * R
    factor_ops = N + sum((N - j - 1) + (N - j - 1) * (N - j)
                         for j in range(N))
    if name == "ldl_factor":
        nbytes = B * f8 * (tri + N + stri + N) + B
        ops = factor_ops
    elif name == "ldl_solve":
        nbytes = B * f8 * (stri + N + 2 * N * R)
        ops = solve_ops
    elif name == "kkt_residual":
        nbytes = B * f8 * (tri + 3 * N * R)
        ops = 2 * N * N * R
    elif name == "ldl_solve_refine":
        nbytes = B * f8 * (tri + stri + N + 3 * N * R)
        ops = (1 + npass) * (solve_ops + 2 * N * N * R) + npass * N * R
    else:
        raise ValueError(f"no work model for {name!r}")
    return nbytes, B * ops


def bound_seconds(nbytes, flops):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the f64 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_FLOP_PER_S)


def union_seconds(spans):
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, -np.inf
    for t0, t1 in sorted(spans):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def clip_spans(spans, windows):
    """The parts of `spans` that lie inside any of `windows` (both lists
    of (start, end)); `windows` must not overlap."""
    out = []
    for w0, w1 in sorted(windows):
        for t0, t1 in spans:
            a, b = max(t0, w0), min(t1, w1)
            if b > a:
                out.append((a, b))
    return out


def p90(values):
    """The 90th percentile of all values, by linear interpolation between
    order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=float), 90))
