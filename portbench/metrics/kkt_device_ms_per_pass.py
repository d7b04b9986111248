"""Device ms per loop pass of the kernels launched inside the dense
KKT's factorize and solve ranges."""

from portbench.metrics._common import passes


def read(rec):
    n = passes(rec)
    kkt = rec["layers"].get("kkt")
    if n is None or kkt is None or not kkt["kernels"]:
        return None
    return kkt["device_s"] * 1e3 / n
