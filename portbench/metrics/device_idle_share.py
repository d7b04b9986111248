"""The device's idle share, %: one minus the device's busy time per loop
pass, the union of the intervals of its operations (kernels, copies,
memsets) in the profiled batches, over the host time per loop pass of
as many batches of the same run timed just before them without the
profiler, whose own cost on the host would inflate the share."""

from portbench.metrics._common import passes, plain_passes


def read(rec):
    n, n_plain = passes(rec), plain_passes(rec)
    if not rec["kernels"] or n is None or n_plain is None:
        return None
    wall = sum(rec["plain"]["batch_s"]) / n_plain
    return 100.0 * (1.0 - rec["busy_s"] / n / wall)
