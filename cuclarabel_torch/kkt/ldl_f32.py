"""Batched f32 LDL^T factor and solve: the hand-written Hopper kernels of
`csrc/ldl_f32.cu` (N <= 128) and `csrc/ldl_wide.cu` (N > 128) and their
plain PyTorch versions.

The counterpart of `cuclarabel_tpu/kkt/pallas_ldl.py`, the single-float
LDL^T that the JAX package keeps beside its f64-grade engine as the f32
baseline.  No solver path calls it; these are its public entry points:

  ldl_factor_batched(K)          -> (L, Dinv)
  ldl_solve_batched(L, Dinv, b)  -> x

Everything is float32 in and out (the reference runs with x64 off; no
operand is upcast here), batch-first: K and L (B, N, N), Dinv and b
(B, N), any B and N.  K must be symmetric quasidefinite: only its
lower triangle is read, as the reference reads the column below each
pivot.  L is the strict-lower unit factor of K = (I + L) D (I + L)^T
with zeros on and above the diagonal (the reference leaves junk there),
and Dinv holds D^-1.  On CPU tensors the plain versions run; on CUDA
tensors the kernels launch, with no fallback from one to the other: the
narrow forms at N <= 128, the wide ones above (the f64 wide bodies at
T = float, without regularisation; the triangle in shared memory up to
N = 320 for the factor and N = 256 for the substitution on an H100,
`ldl.factor_form(N, torch.float32)` and `ldl.solve_form(N, 1,
torch.float32)` name the form).  Launches are counted in
`ldl.LAUNCHES` under "ldl_factor_batched/r1" and "ldl_solve_batched/r1"
(narrow) or "ldl_factor_batched_wide/r1" and "ldl_solve_batched_wide/r1"
(wide), plain calls in `ldl.PLAIN_CALLS` under the narrow keys.
"""

import torch

from . import _build
from .ldl import (LAUNCHES, PLAIN_CALLS, _check, _dims, _factor, _on_cpu,
                  _raise_on, _solve, _stream, launch_key, wide)

F32 = torch.float32


def ldl_factor_batched_plain(K):
    PLAIN_CALLS.add("ldl_factor_batched/r1")
    L, Dinv, _ = _factor(K, None)
    return L, Dinv


def ldl_solve_batched_plain(L, Dinv, b):
    PLAIN_CALLS.add("ldl_solve_batched/r1")
    return _solve(L, Dinv, b)


def ldl_factor_batched(K):
    """Pivot-free LDL^T of a batch of symmetric quasidefinite f32 K
    (B, N, N).  Returns L (B, N, N) and Dinv (B, N), both f32."""
    B, N = _dims(K, "K")
    _check("K", K, (B, N, N), F32)
    if _on_cpu(K):
        return ldl_factor_batched_plain(K)
    L = torch.empty_like(K)
    Dinv = K.new_empty(B, N)
    lib = _build.load()
    fn = lib.cc_ldl_factor_wide_f32 if wide(N) else lib.cc_ldl_factor_f32
    with torch.cuda.device(K.device):
        rc = fn(K.data_ptr(), L.data_ptr(), Dinv.data_ptr(), B, N, _stream(K))
    _raise_on(rc, "ldl_factor_batched")
    LAUNCHES.add(launch_key("ldl_factor_batched", N, 1), K.device)
    return L, Dinv


def ldl_solve_batched(L, Dinv, b):
    """x with (I + L) D (I + L)^T x = b for factors from
    ldl_factor_batched; b (B, N) f32."""
    B, N = _dims(L, "L")
    _check("L", L, (B, N, N), F32)
    _check("Dinv", Dinv, (B, N), F32)
    _check("b", b, (B, N), F32)
    if _on_cpu(L, Dinv, b):
        return ldl_solve_batched_plain(L, Dinv, b)
    x = torch.empty_like(b)
    lib = _build.load()
    fn = lib.cc_ldl_solve_wide_f32 if wide(N) else lib.cc_ldl_solve_f32
    with torch.cuda.device(L.device):
        rc = fn(L.data_ptr(), Dinv.data_ptr(), b.data_ptr(), x.data_ptr(), B,
                N, _stream(L))
    _raise_on(rc, "ldl_solve_batched")
    LAUNCHES.add(launch_key("ldl_solve_batched", N, 1), L.device)
    return x
