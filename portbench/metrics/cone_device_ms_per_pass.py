"""Device ms per loop pass of the kernels launched inside the cone ops'
ranges (cones/ops.py entry points)."""

from portbench.metrics._common import passes


def read(rec):
    n = passes(rec)
    cones = rec["layers"].get("cones")
    if n is None or cones is None or not cones["kernels"]:
        return None
    return cones["device_s"] * 1e3 / n
