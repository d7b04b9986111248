"""Shared numerics of the nonsymmetric (exp, pow, genpow) cones, batched.

The counterpart of `cuclarabel_tpu/cones/nonsymmetric.py` (reference
`src/cones/coneops_nonsymmetric_common.jl`).  The reference writes each
function for one problem and lets `vmap` batch it; here every tensor
carries the batch as dim 0: per-cone points (B, k, 3), per-cone scalars
(B, k), per-problem scalars (B,).

The reference's bounded `lax.while_loop`s become masked Python loops:
each (problem, cone) of the Newton solve, and each problem of the
backtracking search, has an `active` flag and freezes once it stops; the
loop runs while any flag is up and fewer than `max_iter` steps have run.
That is what the reference's while_loop does under `vmap`: every lane
steps until the last one stops, and a stopped lane keeps its carry.
Reading "any flag up" is one host sync per step.
"""

import numpy as np
import torch

F64EPS = float(np.finfo(np.float64).eps)
SQRT_EPS = float(np.sqrt(np.finfo(np.float64).eps))
BIG = 1e30


def logsafe(x):
    """log with a large negative (finite) value for nonpositive args
    (mathutils.jl:12-18); finite so downstream arithmetic stays
    NaN-free."""
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)), -BIG)


def solve_3x3_sym(H, b):
    """Explicit 3x3 Cholesky solve of SPD systems H x = b, H (..., 3, 3),
    b (..., 3) (cholesky_3x3_explicit_factor!/solve!).  NaNs for non-SPD
    inputs; callers mask on finiteness."""
    a, bb, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    l11 = torch.sqrt(a)
    l21 = bb / l11
    l31 = c / l11
    l22 = torch.sqrt(d - l21 * l21)
    l32 = (e - l21 * l31) / l22
    l33 = torch.sqrt(f - l31 * l31 - l32 * l32)
    # forward: L y = b
    y1 = b[..., 0] / l11
    y2 = (b[..., 1] - l21 * y1) / l22
    y3 = (b[..., 2] - l31 * y1 - l32 * y2) / l33
    # backward: L' x = y
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    return torch.stack([x1, x2, x3], dim=-1)


def newton_raphson_onesided(x0, f0, f1, max_iter: int = 100):
    """One-sided Newton-Raphson from x0 (B, k), left of the root with
    f0(x0) > 0; f0 and f1 map (B, k) -> (B, k).  Stops per cone when
    dx < eps, |dx/x| < sqrt(eps) or |f'| < eps."""
    x = x0
    active = torch.ones_like(x0, dtype=torch.bool)
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        dfdx = f1(x)
        safe_dfdx = torch.where(dfdx.abs() > 0, dfdx, 1.0)
        dx = -f0(x) / safe_dfdx
        stop = ((dx < F64EPS)
                | ((dx / torch.where(x != 0, x, 1.0)).abs() < SQRT_EPS)
                | (dfdx.abs() < F64EPS))
        x = torch.where(active & ~stop, x + dx, x)
        active = active & ~stop
    return x


def _outer(u, v):
    return u[..., :, None] * v[..., None, :]


def primal_dual_scaling_3x3(s, z, st, zt, H):
    """BFGS primal-dual scaling Hs of 3-d cones: s, z (..., 3) the primal
    and dual points, st = grad f*(z), zt = grad f(s), H the dual Hessian
    (..., 3, 3).  Per cone the primal-dual Hs where the central-path
    guards pass, else the dual scaling mu H
    (coneops_nonsymmetric_common.jl:107-164)."""
    dot_sz = (s * z).sum(dim=-1)
    mu = dot_sz / 3.0
    mut = (zt * st).sum(dim=-1) / 3.0

    ds = s + mu[..., None] * st
    dz = z + mu[..., None] * zt
    dot_dsz = (ds * dz).sum(dim=-1)

    de1 = mu * mut - 1.0
    Hzt = (H * zt[..., None, :]).sum(dim=-1)
    de2 = (zt * Hzt).sum(dim=-1) - 3.0 * mut * mut

    guard = ((de1.abs() > SQRT_EPS) & (de2.abs() > F64EPS)
             & (dot_sz > 0) & (dot_dsz > 0))

    safe_de2 = torch.where(de2.abs() > 0, de2, 1.0)
    tmp = mut[..., None] * st - Hzt
    M = (H - _outer(st, st) / 3.0
         - _outer(tmp, tmp) / safe_de2[..., None, None])
    t = mu * torch.sqrt((M * M).sum(dim=(-2, -1)))

    axis = torch.linalg.cross(z, zt, dim=-1)
    axis_norm = torch.sqrt((axis * axis).sum(dim=-1))
    axis = axis / torch.where(axis_norm > 0, axis_norm, 1.0)[..., None]

    safe_sz = torch.where(dot_sz > 0, dot_sz, 1.0)
    safe_dsz = torch.where(dot_dsz > 0, dot_dsz, 1.0)
    Hs_pd = (_outer(s, s) / safe_sz[..., None, None]
             + _outer(ds, ds) / safe_dsz[..., None, None]
             + t[..., None, None] * _outer(axis, axis))

    guard = guard & (t > 0) & torch.isfinite(Hs_pd).all(dim=-1).all(dim=-1)
    Hs_dual = mu[..., None, None] * H
    return torch.where(guard[..., None, None], Hs_pd, Hs_dual)


def backtrack_alpha(alpha0, all_feasible_fn, settings, max_iter: int = 64):
    """Backtrack one alpha per problem, alpha0 (B,), until all of that
    problem's cones are feasible (all_feasible_fn: (B,) -> (B,) bool;
    composite of backtrack_search, coneops_nonsymmetric_common.jl:5-34):
    alpha *= step until feasible; 0 once alpha < min_terminate."""
    step = settings.linesearch_backtrack_step
    amin = settings.min_terminate_step_length
    a = alpha0
    done = torch.zeros_like(alpha0, dtype=torch.bool)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        feas = all_feasible_fn(a)
        a_next = torch.where(feas, a, a * step)
        dead = ~feas & (a_next < amin)
        a_next = torch.where(dead, 0.0, a_next)
        a = torch.where(done, a, a_next)
        done = done | feas | dead
    return a
