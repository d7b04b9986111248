"""The LDL^T kernels' share of their roofline, %: the sum over every
wrapped call of ldl_factor, ldl_solve, kkt_residual and
ldl_solve_refine of its least time (`yardstick.work` at the call's own
B, N, R and npass, against the H100's 3.35 TB/s and 67 TFLOP/s f64),
over the sum of the device time of the kernels each call launched.
None where no such call ran (the library LU path)."""

from portbench import yardstick


def _dims(entry, args):
    B, N = args[0][0], args[0][1]
    rhs = [a for a in args if isinstance(a, tuple)][-1]
    R = rhs[2] if len(rhs) == 3 else 1
    npass = args[4] if entry == "ldl_solve_refine" else 1
    return B, N, R, npass


def read(rec):
    ldl = rec["layers"].get("ldl")
    calls = [c for c in (ldl or {}).get("calls", []) if c["kernels"]]
    if not calls:
        return None
    bound = sum(yardstick.bound_seconds(
        *yardstick.work(c["entry"], *_dims(c["entry"], c["args"])))
        for c in calls)
    return 100.0 * bound / sum(c["device_s"] for c in calls)
