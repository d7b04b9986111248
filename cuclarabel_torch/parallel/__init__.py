"""Batched solving on one device."""

from .batch import BatchSolver, device_equilibrate, make_batch_solve_fn

__all__ = ["BatchSolver", "device_equilibrate", "make_batch_solve_fn"]
