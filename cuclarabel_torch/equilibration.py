"""Ruiz equilibration (host-side, setup-time).

A copy of `cuclarabel_tpu/equilibration.py` (the JAX package is the
reference; the port imports nothing from it).

Behavioral parity with `data_equilibrate!` (`src/problemdata.jl:133-221`):
iterative inf-norm row/column scaling of [P A'; A 0] with cumulative
clipping, cost scaling from max(||q||_inf, mean column norm of P), and
cone rectification (non-elementwise-scalable cones forced to the scalar
mean scaling, coneops_defaults.jl:32-44).

Runs once per setup on the host in dense numpy — the scaled operands are
what get shipped to the device.  (A sparse variant will accompany the
block-sparse KKT backend.)
"""

from typing import Tuple

import numpy as np


def ruiz_equilibrate(
    P: np.ndarray,
    A: np.ndarray,
    q: np.ndarray,
    b: np.ndarray,
    layout,
    settings,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """Returns (P, A, q, b, d, e, c) with P = c*D P D, A = E A D,
    q = c*D q, b = E b."""
    n = q.shape[0]
    m = b.shape[0]
    P = P.copy()
    A = A.copy()
    q = q.copy()
    b = b.copy()
    d = np.ones(n)
    e = np.ones(m)
    c = 1.0

    if not settings.equilibrate_enable:
        return P, A, q, b, d, e, c

    smin = settings.equilibrate_min_scaling
    smax = settings.equilibrate_max_scaling

    for _ in range(settings.equilibrate_max_iter):
        # column norms of [P; A] and row norms of A (mathutils.jl:129-141);
        # P here is stored full-symmetric so plain column norms are the
        # symmetric column norms.
        colP = np.abs(P).max(axis=0) if n > 0 else np.zeros(0)
        colA = np.abs(A).max(axis=0) if m > 0 else np.zeros(n)
        dwork = np.maximum(colP, colA)
        ework = np.abs(A).max(axis=1) if n > 0 else np.zeros(m)

        dwork[dwork == 0.0] = 1.0
        ework[ework == 0.0] = 1.0
        dwork = 1.0 / np.sqrt(dwork)
        ework = 1.0 / np.sqrt(ework)

        # bound the cumulative scaling (problemdata.jl:174-176)
        dwork = np.clip(dwork, smin / d, smax / d)
        ework = np.clip(ework, smin / e, smax / e)

        # scale data (problemdata.jl:224-243)
        P *= dwork[None, :]
        P *= dwork[:, None]
        A *= dwork[None, :]
        A *= ework[:, None]
        q *= dwork
        b *= ework
        d *= dwork
        e *= ework

        # cost scaling (problemdata.jl:185-201)
        mean_col_norm_P = np.abs(P).max(axis=0).mean() if n > 0 else 0.0
        inf_norm_q = np.abs(q).max() if n > 0 else 0.0
        if mean_col_norm_P != 0.0 and inf_norm_q != 0.0:
            scale_cost = max(inf_norm_q, mean_col_norm_P)
            ctmp = 1.0 / scale_cost
            ctmp = float(np.clip(ctmp, smin / c, smax / c))
            P *= ctmp
            q *= ctmp
            c *= ctmp

    # cone rectification (problemdata.jl:206-214): non-elementwise cones
    # get the scalar mean scaling over their range
    delta = np.ones(m)
    changed = False
    for lo, hi in layout.rectification_ranges():
        er = e[lo:hi]
        dmean = er.mean()
        dr = dmean / er
        if not np.allclose(dr, 1.0):
            changed = True
            delta[lo:hi] = dr
    if changed:
        A *= delta[:, None]
        b *= delta
        e *= delta

    return P, A, q, b, d, e, c
