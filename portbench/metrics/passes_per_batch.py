"""IPM loop passes per batch, stage 1 and stage 2 together: the calls
of the loop_pass that run_passes drives."""

from portbench.metrics._common import passes


def read(rec):
    n = passes(rec)
    return None if n is None else n / rec["batches"]
