"""Batched solving on one device."""

from .batch import BatchSolver, device_equilibrate, make_batch_solve_fn
from .sparse_batch import BatchSparseSolver, device_sparse_equilibrate

__all__ = ["BatchSolver", "BatchSparseSolver", "device_equilibrate",
           "device_sparse_equilibrate", "make_batch_solve_fn"]
