"""Kernel launches per loop pass in the profiled batches (every kernel
event of the batches, equilibration and post-processing included)."""

from portbench.metrics._common import passes


def read(rec):
    n = passes(rec)
    return None if n is None or not rec["kernels"] else rec["kernels"] / n
