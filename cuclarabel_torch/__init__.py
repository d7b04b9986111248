"""cuclarabel_torch: the interior-point conic solver on PyTorch and CUDA.

A port of `cuclarabel_tpu` (JAX, the reference) to one NVIDIA H100.  It
imports torch and never jax, and nothing of the JAX package; the modules
it shares with the reference are copies (`settings`, `statuscodes`,
`infinity`, `cones/api`, `cones/layout`, `equilibration`, `presolve`,
`warmstart`, `info_print`, `json_io`, `qps`, `kkt/sparse_symbolic`,
`native`).

It covers the dense path on problems with zero, nonnegative,
second-order, exponential, power and generalised power cones, with or
without P: the single-problem `Solver`
(presolve, host equilibration, warm starts, data updates, JSON files,
the verbose table) and the batched `BatchSolver`, through the dense KKT
backend whose LDL^T factorisation, substitution, residual and refined
solve are hand-written CUDA kernels (`kkt/ldl.py`, `csrc/ldl.cu`), and
the f32 batched LDL^T entry points `ldl_factor_batched` and
`ldl_solve_batched` (`kkt/ldl_f32.py`, `csrc/ldl_f32.cu`).  The issue-rate
probes of the JAX package's `scripts/` have counterparts in `probes/`
(`csrc/probes.cu`), run as their own entry points.  Solves run
on the CUDA device unless the caller passes device="cpu", where the
kernels' plain PyTorch versions run instead.

The sparse paths: `SparseSolver` and `parallel.BatchSparseSolver` keep
the data sparse and factor the KKT system with the level-scheduled
multifrontal LDL^T (`kkt/sparse_device.py`, plain torch on the device),
and `Solver(direct_solve_method="qdldl")` factors it on the host with
the native sparse LDL^T (`native/`, C++ built with g++ on first use).
`qps` reads and writes QPS files.

Several devices: `ShardedSolver` splits one large problem's constraint
rows over several cards (the block-arrow KKT of `kkt/arrow.py`), and
`BatchSolver` and `BatchSparseSolver` with n_devices > 1 split a batch
into slabs, one per card, each run by its own host thread.  The
modeling layer (`Model`, `Variable`, `vstack`, `sum_entries`, `norm2`,
`quad_form`, `sumsq`) assembles `(P, q, A, b, cones)` and solves through
`Solver` or `SparseSolver`; `precompile()` solves one small problem per
cone family to pay the one-time costs up front.
"""

from .cones.api import (
    ExponentialConeT,
    GenPowerConeT,
    NonnegativeConeT,
    PowerConeT,
    PSDTriangleConeT,
    SecondOrderConeT,
    SupportedCone,
    ZeroConeT,
)
from .infinity import default_infinity, get_infinity, set_infinity
from .kkt.ldl_f32 import ldl_factor_batched, ldl_solve_batched
from .modeling import (
    Model,
    Variable,
    norm2,
    quad_form,
    sum_entries,
    sumsq,
    vstack,
)
from .parallel.batch import BatchSolver
from .parallel.sharded import ShardedSolver
from .parallel.sparse_batch import BatchSparseSolver
from .precompile import precompile
from .settings import Settings
from .solver import DefaultSolution, Solver
from .sparse_solver import SparseSolver
from .statuscodes import SolverStatus

__version__ = "0.1.0"


def solver_name() -> str:
    """Solver name string, as the verbose banner prints it (reference:
    src/version.jl solver_name())."""
    return "cuclarabel_torch"


def version() -> str:
    """Package version string (reference: src/version.jl version())."""
    return __version__


__all__ = [
    "BatchSolver",
    "BatchSparseSolver",
    "DefaultSolution",
    "ExponentialConeT",
    "GenPowerConeT",
    "Model",
    "NonnegativeConeT",
    "PowerConeT",
    "PSDTriangleConeT",
    "SecondOrderConeT",
    "Settings",
    "ShardedSolver",
    "Solver",
    "SolverStatus",
    "SparseSolver",
    "SupportedCone",
    "Variable",
    "ZeroConeT",
    "default_infinity",
    "get_infinity",
    "ldl_factor_batched",
    "ldl_solve_batched",
    "norm2",
    "precompile",
    "quad_form",
    "set_infinity",
    "solver_name",
    "sum_entries",
    "sumsq",
    "version",
    "vstack",
]
