"""The plain reference solver: a primal-dual interior-point method with
Nesterov-Todd scaling and Mehrotra's predictor-corrector, in NumPy, one
problem at a time, after Vandenberghe's CVXOPT `coneqp` (The CVXOPT
linear and quadratic cone program solvers, 2010, sections 7-9).

    min 1/2 x'Px + q'x   s.t.  A x + s = b,  s in K

K a product of zero, nonnegative, second-order and PSD (svec) cones.
Zero-cone rows are equality constraints with free multipliers.  It
shares no code with the program and takes nothing the program made:
only the generated data.  `dtype` sets the precision of every array
and of the LAPACK calls (float32 is the benchmark's control).
"""

import warnings

import numpy as np
import scipy.linalg

from . import cones as C


def _split(A, b, cones):
    zero = np.zeros(A.shape[0], dtype=bool)
    for kind, dim, sl in C.slices(cones):
        if kind == "zero":
            zero[sl] = True
    return zero, [c for c in cones if c[0] != "zero"]


def _step(kc, nu, e, s, z, rd, re, rp, n, p, kkt):
    """One predictor-corrector step from interior s, z: (alpha, dx, dy,
    ds, dz), or None where a quantity is not finite."""
    W, lam = C.nt_scaling(kc, s, z)
    if not (np.isfinite(W).all() and np.isfinite(lam).all()):
        return None
    G = W.T @ W
    F = kkt(G)
    mu = (s @ z) / nu

    def newton(dc):
        t = W.T @ C.inv_circ(kc, lam, dc)
        sol = scipy.linalg.lu_solve(F, np.concatenate(
            [-rd, -re, -rp - t]), check_finite=False)
        dx, dy, dz = sol[:n], sol[n:n + p], sol[n + p:]
        return dx, dy, dz, t - G @ dz

    lam2 = C.circ(kc, lam, lam)
    dxa, dya, dza, dsa = newton(-lam2)
    if not (np.isfinite(dsa).all() and np.isfinite(dza).all()):
        return None
    amax = min(C.step_to_boundary(kc, s, dsa),
               C.step_to_boundary(kc, z, dza))
    sigma = (1 - min(1.0, amax)) ** 3
    Winv_ds = np.linalg.solve(W.T, dsa)
    dc = -lam2 + sigma * mu * e - C.circ(kc, Winv_ds, W @ dza)
    dx, dy, dz, ds = newton(dc)
    if not all(np.isfinite(v).all() for v in (dx, dy, dz, ds)):
        return None
    amax = min(C.step_to_boundary(kc, s, ds),
               C.step_to_boundary(kc, z, dz))
    alpha = min(1.0, 0.99 * amax)
    if not np.isfinite(alpha) or alpha <= 0:
        return None
    return alpha, dx, dy, ds, dz


def solve(P, q, A, b, cones, dtype=np.float64, tol=1e-10, max_iter=100,
          solved_tol=None):
    """Solve one problem, to tol.  Returns {"x", "s", "z", "obj",
    "solved", "iterations", "pres", "dres", "gap"}: the iterate with the
    least max(pres, dres, gap) met, in float64; s and z on every row, the
    zero cone's s = 0 and z its multipliers; solved where all three are
    below solved_tol (default: tol)."""
    n = q.shape[0]
    zero, kc = _split(A, b, cones)
    A = np.asarray(A, dtype)
    q = np.asarray(q, dtype)
    b = np.asarray(b, dtype)
    P = np.zeros((n, n), dtype) if P is None else np.asarray(P, dtype)
    Ae, be = A[zero], b[zero]
    Ac, bc = A[~zero], b[~zero]
    p, mc = Ae.shape[0], Ac.shape[0]
    nu = C.degree(kc)
    e = C.unit(kc, dtype)
    N = n + p + mc

    def kkt(G):
        """LU of the KKT matrix; a singular one gives non-finite steps,
        which end the iteration."""
        K = np.zeros((N, N), dtype)
        K[:n, :n] = P
        K[:n, n:n + p] = Ae.T
        K[n:n + p, :n] = Ae
        K[:n, n + p:] = Ac.T
        K[n + p:, :n] = Ac
        K[n + p:, n + p:] = -G
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
            return scipy.linalg.lu_factor(K, check_finite=False)

    def shift(v):
        a = -C.min_eig(kc, v)
        return v if a < 0 else v + (1 + a) * e

    # start (coneqp's default): least-norm s and z, shifted inside
    F = kkt(np.eye(mc, dtype=dtype))
    sol = scipy.linalg.lu_solve(F, np.concatenate(
        [np.zeros(n, dtype), be, bc]))
    x, y = sol[:n], sol[n:n + p]
    s = shift(bc - Ac @ x)
    sol = scipy.linalg.lu_solve(F, np.concatenate(
        [-q, np.zeros(p + mc, dtype)]))
    y = sol[n:n + p]
    z = shift(sol[n + p:])

    nb = max(1.0, float(np.linalg.norm(b)))
    nq = max(1.0, float(np.linalg.norm(q)))
    best, best_err = None, np.inf
    for it in range(max_iter + 1):
        rd = P @ x + Ae.T @ y + Ac.T @ z + q
        re = Ae @ x - be
        rp = Ac @ x + s - bc
        xPx = x @ P @ x
        pcost = q @ x + xPx / 2
        dcost = -(be @ y) - (bc @ z) - xPx / 2
        pres = float(np.sqrt(re @ re + rp @ rp)) / nb
        dres = float(np.linalg.norm(rd)) / nq
        gap = float(abs(pcost - dcost)) / max(1.0, min(abs(float(pcost)),
                                                      abs(float(dcost))))
        err = max(pres, dres, gap)
        if np.isfinite(err) and err < best_err:
            best_err = err
            best = (x.copy(), y.copy(), s.copy(), z.copy(), it, pres, dres,
                    gap)
        if err < tol or it == max_iter or not np.isfinite(err):
            break
        try:
            with np.errstate(all="ignore"):
                step = _step(kc, nu, e, s, z, rd, re, rp, n, p, kkt)
        except (np.linalg.LinAlgError, ValueError):
            break  # a lower precision runs out of interior: keep the best
        if step is None:
            break
        alpha, dx, dy, ds, dz = step
        x, y, s, z = (x + alpha * dx, y + alpha * dy, s + alpha * ds,
                      z + alpha * dz)

    x, y, s, z, it, pres, dres, gap = best
    s_all = np.zeros(A.shape[0])
    z_all = np.zeros(A.shape[0])
    s_all[~zero] = s
    z_all[zero] = y
    z_all[~zero] = z
    x = x.astype(np.float64)
    Pd = P.astype(np.float64)
    return {"x": x, "s": s_all, "z": z_all,
            "obj": float(q.astype(np.float64) @ x + x @ Pd @ x / 2),
            "solved": max(pres, dres, gap) < (solved_tol or tol),
            "iterations": it,
            "pres": pres, "dres": dres, "gap": gap}
