"""Optimality certificates of returned answers, in plain NumPy.

A conic program's optimal point need not be unique (the portfolio's
dual is not: t >= 0 and the SOC's t >= ||F'x|| share a multiplier), so
the benchmark does not compare x or z with the reference's.  It checks
what every SOLVED answer claims: with the configuration's tolerances,
x, s, z are primal and dual feasible and their gap is closed.  The
measures are Clarabel's own (`info.jl`), worked out again from the
generated data and the returned x, s, z, with s and z first projected
onto their cones, so that an answer outside its cone reads as the
residual it leaves:

    res_primal = ||A x + proj(s) - b||_2 / max(1, ||b||_inf + ||x||_2 + ||s||_2)
    res_dual   = ||P x + A' proj*(z) + q||_2 / max(1, ||q||_inf + ||x||_2 + ||z||_2)
    gap        = min(|p - d|, |p - d| / max(1, min(|p|, |d|)))
    p = q'x + x'Px/2,  d = -b'z - x'Px/2

A SOLVED answer claims all three below tol_feas, tol_feas and
tol_gap (1e-8 by default).  NaN reads as inf.
"""

import numpy as np

from . import cones as C


def measures(P, A, cones, q, b, x, s, z):
    """(res_primal, res_dual, gap), each (B,), for B answers: q, b, x,
    s, z (B, .); A (m, n) shared or (B, m, n); P None, (n, n) or
    (B, n, n)."""
    ps = C.project(cones, s)
    pz = C.project(cones, z, dual=True)
    if A.ndim == 2:
        Ax, Atz = x @ A.T, pz @ A
    else:
        Ax = np.einsum("bmn,bn->bm", A, x)
        Atz = np.einsum("bmn,bm->bn", A, pz)
    if P is None:
        Px = np.zeros_like(x)
    elif P.ndim == 2:
        Px = x @ P.T
    else:
        Px = np.einsum("bij,bj->bi", P, x)
    nx = np.linalg.norm(x, axis=1)
    rp = np.linalg.norm(Ax + ps - b, axis=1) / np.maximum(
        1.0, np.abs(b).max(axis=1) + nx + np.linalg.norm(s, axis=1))
    rd = np.linalg.norm(Px + Atz + q, axis=1) / np.maximum(
        1.0, np.abs(q).max(axis=1) + nx + np.linalg.norm(z, axis=1))
    xPx = np.sum(x * Px, axis=1)
    pc = np.sum(q * x, axis=1) + xPx / 2
    dc = -np.sum(b * z, axis=1) - xPx / 2
    gap_abs = np.abs(pc - dc)
    gap = np.minimum(gap_abs, gap_abs / np.maximum(
        1.0, np.minimum(np.abs(pc), np.abs(dc))))
    return tuple(np.where(np.isnan(v), np.inf, v) for v in (rp, rd, gap))
