"""Shared arithmetic of the per-layer readers."""

LOOP = "pb:ipm_loop:run_passes"
LOOP_PASSES = LOOP + "#arg1"


def passes(rec):
    """Loop passes counted in the profiled batches (None if none)."""
    n = rec.get("counts", {}).get(LOOP_PASSES, 0)
    return n or None


def plain_passes(rec):
    """Loop passes counted in the batches timed without the profiler."""
    n = rec.get("plain", {}).get("counts", {}).get(LOOP_PASSES, 0)
    return n or None
