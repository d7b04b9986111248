"""cuclarabel_torch: the interior-point conic solver on PyTorch and CUDA.

A port of `cuclarabel_tpu` (JAX, the reference) to one NVIDIA H100.  It
imports torch and never jax, and nothing of the JAX package; the modules
it shares with the reference are copies (`settings`, `statuscodes`,
`infinity`, `cones/api`, `cones/layout`).

This slice covers the batched dense path: `BatchSolver` on problems with
zero, nonnegative and second-order cones, with or without P, through the
dense KKT backend whose LDL^T factorisation, substitution, residual and
refined solve are hand-written CUDA kernels (`kkt/ldl.py`,
`csrc/ldl.cu`).  Solves run on the CUDA device unless the caller passes
device="cpu", where the kernels' plain PyTorch versions run instead.
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
from .parallel.batch import BatchSolver
from .settings import Settings
from .solver import DefaultSolution
from .statuscodes import SolverStatus

__all__ = [
    "BatchSolver",
    "DefaultSolution",
    "ExponentialConeT",
    "GenPowerConeT",
    "NonnegativeConeT",
    "PowerConeT",
    "PSDTriangleConeT",
    "SecondOrderConeT",
    "Settings",
    "SolverStatus",
    "SupportedCone",
    "ZeroConeT",
    "default_infinity",
    "get_infinity",
    "set_infinity",
]
