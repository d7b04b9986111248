"""Shared warm-start plumbing used by every solver class.

A copy of `cuclarabel_tpu/warmstart.py` (the JAX package is the
reference; the port imports nothing from it).

Warm iterates arrive in the ORIGINAL problem space; the IPM runs in
the Ruiz-equilibrated space (data_equilibrate!, problemdata.jl:133-221
conventions), whose unscale at tau = 1 is x·d, z·e/c, s/e — so the
inverse applied here is x/d, s·e, z/e·c.  Keeping this single
implementation stops the five solver classes from drifting."""

from typing import Tuple


def validate_warm_start(layout, warm_start, n: int, m: int,
                        batch: int = 0) -> Tuple:
    """Common guards: symmetric-cone layouts only, correct shapes.
    Returns (wx, ws, wz) as float64 numpy arrays."""
    import numpy as np

    if not layout.is_symmetric:
        raise ValueError("warm_start supports symmetric-cone problems only")
    wx, ws, wz = (np.asarray(v, dtype=float) for v in warm_start)
    if batch:
        want = ((batch, n), (batch, m), (batch, m))
        label = "(B,n), (B,m), (B,m)"
    else:
        want = ((n,), (m,), (m,))
        label = "(n,), (m,), (m,)"
    if wx.shape != want[0] or ws.shape != want[1] or wz.shape != want[2]:
        raise ValueError(f"warm_start shapes must be {label}")
    return wx, ws, wz


def scale_warm_start(wx, ws, wz, d, e, cscale):
    """Into the equilibrated space (inverse of the loop's unscale at
    tau = 1).  Works elementwise, so batched (B, ...) iterates pass
    through with broadcast d/e."""
    return wx / d, ws * e, wz / e * cscale
