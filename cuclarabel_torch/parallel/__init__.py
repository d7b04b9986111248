"""Batched solving, on one device or data-parallel over several, and
one problem's constraint rows split over several devices."""

from .batch import BatchSolver, device_equilibrate, make_batch_solve_fn
from .sharded import ShardedSolver
from .sparse_batch import BatchSparseSolver, device_sparse_equilibrate

__all__ = ["BatchSolver", "BatchSparseSolver", "ShardedSolver",
           "device_equilibrate", "device_sparse_equilibrate",
           "make_batch_solve_fn"]
