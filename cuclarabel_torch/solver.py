"""Solution type and device choice.

The public `Solver` class of the reference (`cuclarabel_tpu/solver.py`)
is not ported yet; this module holds what the batch front end needs.
"""

import dataclasses

import numpy as np
import torch

from .statuscodes import SolverStatus, status_to_string


@dataclasses.dataclass
class DefaultSolution:
    """User-facing results (types.jl:279-311)."""

    x: np.ndarray
    z: np.ndarray
    s: np.ndarray
    status: SolverStatus
    obj_val: float
    obj_val_dual: float
    solve_time: float
    iterations: int
    r_prim: float
    r_dual: float

    def __repr__(self):
        return (
            f">>> cuclarabel_torch - Results\n"
            f"Status: {status_to_string(self.status)}\n"
            f"Iterations: {self.iterations}\n"
            f"Objective: {self.obj_val:#.4g}\n"
            f"Solve time: {self.solve_time:.3e}s"
        )


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: CUDA unless the caller names another.
    With no CUDA device and no explicit choice this raises; it never
    drops to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cuclarabel_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to solve on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
