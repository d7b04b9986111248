"""Warm-up workloads (the reference's precompile.jl analog).

The counterpart of `cuclarabel_tpu/precompile.py`, with its API: solve
one small problem per cone family through the public `Solver` (the
reference's cone list, `src/precompile.jl:50-57`), and optionally
production-shape `signatures`, so that a user's first solve finds the
slow one-time steps done.  What persists, on the card's machine:

  * on disk: the nvcc-built kernel library and the g++-built native
    LDL^T under `build/` beside the package (each named by a hash of
    its sources and flags), so a later process loads them instead of
    compiling;
  * per process only: the CUDA context, the cuBLAS and cuSOLVER
    handles, the lazy loads of CUDA modules and the library's ctypes
    binding; `precompile()` pays these once in the process that calls
    it, and a new process pays them again.

There is no compilation cache to fill: the port runs eagerly, so the
Python work of a solve is paid on every solve.

    precompile()                      # every family, on the card
    precompile(families=("qp",), device="cpu")
    precompile(signatures=[lambda: BatchSolver(...)])

Each signature is a prebuilt solver object (anything with `.solve()`:
Solver, SparseSolver, BatchSolver, ShardedSolver, ...) or a
zero-argument callable returning one.
"""

import time
from typing import Callable, Iterable, Sequence, Union

import numpy as np

__all__ = ["precompile"]


def _lp():
    import cuclarabel_torch as cc

    # min q'x  s.t.  sum x = 1, x >= 0  (basic_lp.jl class)
    n = 4
    q = np.linspace(-1.0, 1.0, n)
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n)])
    return None, q, A, b, [cc.ZeroConeT(1), cc.NonnegativeConeT(n)]


def _qp():
    import cuclarabel_torch as cc

    # the reference QP golden problem class (basic_qp.jl:35-80)
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.ones((1, 2)), -np.eye(2), np.eye(2)])
    b = np.array([1.0, 0.0, 0.0, 1.0, 1.0])
    return P, q, A, b, [cc.ZeroConeT(1), cc.NonnegativeConeT(4)]


def _socp():
    import cuclarabel_torch as cc

    # min x1  s.t. ||(x2, x3)|| <= x1, x1 + x2 = 1
    A = np.vstack([np.array([[1.0, 1.0, 0.0]]), -np.eye(3)])
    b = np.array([1.0, 0.0, 0.0, 0.0])
    q = np.array([1.0, 0.0, 0.1])
    return None, q, A, b, [cc.ZeroConeT(1), cc.SecondOrderConeT(3)]


def _expcone():
    import cuclarabel_torch as cc

    # basic_exp.jl feasible fixture (tests/test_basic_exp.py)
    n = 7
    A1 = np.hstack([np.ones((1, 3)), np.zeros((1, 4))])
    A2 = np.hstack([np.zeros((3, 2)), -np.eye(3), np.zeros((3, 2))])
    A3 = np.zeros((3, n))
    A3[0, 0] = -1.0
    A3[1, 2] = -1.0
    A3[2, 4] = -1.0
    q = np.array([1.0, 0.5, -2.0, -0.1, 1.0, 3.0, 0.0])
    P = np.eye(n) * 1e-1
    A = np.vstack([A1, A2, A3])
    b = np.concatenate([[10.0], np.zeros(6)])
    return P, q, A, b, [
        cc.ZeroConeT(1), cc.NonnegativeConeT(3), cc.ExponentialConeT()
    ]


def _powcone():
    import cuclarabel_torch as cc

    # basic_pow.jl fixture (tests/test_basic_pow.py)
    n = 6
    q = np.zeros(n)
    q[2] = q[5] = -1.0
    A1 = np.eye(6)
    A2 = np.array([[1.0, 2.0, 0.0, 3.0, 0.0, 0.0]])
    A3 = np.array([[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]])
    A = -np.vstack([A1, A2, A3])
    b = np.concatenate([np.zeros(6), [-3.0], [-1.0]])
    return None, q, A, b, [
        cc.PowerConeT(0.6), cc.PowerConeT(0.1),
        cc.ZeroConeT(1), cc.ZeroConeT(1),
    ]


def _genpow():
    import cuclarabel_torch as cc

    # basic_genpow.jl fixture (tests/test_basic_pow.py)
    n = 6
    q = np.zeros(n)
    q[2] = q[5] = -1.0
    A = np.vstack([-np.eye(6),
                   [[1.0, 2.0, 0.0, 3.0, 0.0, 0.0]],
                   [[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]]])
    b = np.concatenate([np.zeros(6), [3.0], [1.0]])
    return None, q, A, b, [
        cc.GenPowerConeT([0.6, 0.4], 1),
        cc.GenPowerConeT([0.1, 0.9], 1),
        cc.ZeroConeT(2),
    ]


def _sdp():
    import cuclarabel_torch as cc

    # basic_sdp.jl class: project an indefinite matrix onto the PSD cone
    P = np.eye(6)
    q = np.zeros(6)
    A = np.eye(6)
    b = np.array([-3.0, 1.0, 4.0, 1.0, 2.0, 5.0])
    return P, q, A, b, [cc.PSDTriangleConeT(3)]


_FAMILIES = {
    "lp": _lp,
    "qp": _qp,
    "socp": _socp,
    "exp": _expcone,
    "pow": _powcone,
    "genpow": _genpow,
    "sdp": _sdp,
}


def precompile(
    settings=None,
    families: Sequence[str] = tuple(_FAMILIES),
    signatures: Iterable[Union[Callable, object]] = (),
    verbose: bool = False,
    device=None,
) -> dict:
    """Solve one small problem per cone family through `Solver` on
    `device` (CUDA unless the caller passes device="cpu"), then each
    signature once (reference precompile.py:153-197).

    settings:   Settings for the family workloads (None = defaults).
    families:   subset of {"lp","qp","socp","exp","pow","genpow","sdp"}.
    signatures: production-shape warmers — prebuilt solver objects
                (anything with .solve()) or zero-arg callables
                returning one; each is solved once.
    Returns {name: seconds}: the first-solve wall time of each workload
    (construction and solve, one-time costs included)."""
    from .solver import Solver

    out = {}
    for name in families:
        make = _FAMILIES[name]
        P, q, A, b, cones = make()
        t0 = time.perf_counter()
        s = Solver(P, q, A, b, cones, settings, device=device)
        s.solve()
        out[name] = round(time.perf_counter() - t0, 3)
        if verbose:
            print(f"precompile[{name}]: {out[name]:.2f}s", flush=True)

    for i, sig in enumerate(signatures):
        obj = sig() if callable(sig) else sig
        t0 = time.perf_counter()
        obj.solve()
        out[f"signature_{i}"] = round(time.perf_counter() - t0, 3)
        if verbose:
            print(f"precompile[signature_{i}]: {out[f'signature_{i}']:.2f}s",
                  flush=True)
    return out
