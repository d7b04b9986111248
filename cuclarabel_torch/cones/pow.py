"""3-d power cones, batched over problems and over the layout's power
cones, each with its own exponent alpha.

The counterpart of `cuclarabel_tpu/cones/pow.py` (reference
`src/cones/coneops_powcone.jl`): per-cone points (B, k, 3), the
exponents `a` (k,), broadcast over the batch.  The composite entry
points take the index plan `p` of `cones/ops.py` (`p.pow_idx`,
`p.pow_alpha`).

Primal cone:  s1^a * s2^(1-a) >= |s3|, s1, s2 >= 0.
Dual cone:    (z1/a)^a * (z2/(1-a))^(1-a) >= |z3|, z1, z2 >= 0.
Dual barrier: f*(z) = -log((z1/a)^(2a) (z2/(1-a))^(2-2a) - z3^2)
              - (1-a) log z1 - a log z2.
"""

import torch

from . import nonsymmetric as ns
from .exp import _sym3
from .nonsymmetric import logsafe

DUAL_ONLY = 1  # must match ipm/loop.py


def _phi_dual(z, a):
    """(z1/a)^(2a) * (z2/(1-a))^(2-2a) via logs (safe for z > 0)."""
    z1, z2 = z[..., 0], z[..., 1]
    return torch.exp(2.0 * a * logsafe(z1 / a)
                     + (2.0 - 2.0 * a) * logsafe(z2 / (1.0 - a)))


def _dual_grad_H(z, a):
    """Gradient and Hessian of f*(z)
    (update_dual_grad_H, coneops_powcone.jl:408-440)."""
    z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2]
    z1s = torch.where(z1 != 0, z1, 1.0)
    z2s = torch.where(z2 != 0, z2, 1.0)
    phi = _phi_dual(z, a)
    psi = phi - z3 * z3
    psis = torch.where(psi != 0, psi, 1.0)

    gp1 = 2.0 * a * phi / (z1s * psis)
    gp2 = 2.0 * (1.0 - a) * phi / (z2s * psis)
    gp3 = -2.0 * z3 / psis

    H11 = (gp1 * gp1 - 2.0 * a * (2.0 * a - 1.0) * phi / (z1s * z1s * psis)
           + (1.0 - a) / (z1s * z1s))
    H12 = gp1 * gp2 - 4.0 * a * (1.0 - a) * phi / (z1s * z2s * psis)
    H22 = (gp2 * gp2
           - 2.0 * (1.0 - a) * (1.0 - 2.0 * a) * phi / (z2s * z2s * psis)
           + a / (z2s * z2s))
    H13 = gp1 * gp3
    H23 = gp2 * gp3
    H33 = gp3 * gp3 + 2.0 / psis
    H = _sym3(H11, H12, H13, H22, H23, H33)

    g1 = -2.0 * a * phi / (z1s * psis) - (1.0 - a) / z1s
    g2 = -2.0 * (1.0 - a) * phi / (z2s * psis) - a / z2s
    g3 = 2.0 * z3 / psis
    return torch.stack([g1, g2, g3], dim=-1), H


def _newton_raphson_powcone(s3, phi, a):
    """Newton-Raphson for the primal-gradient root
    (_newton_raphson_powcone, coneops_powcone.jl:449-478), s3 = |s3|."""
    s3s = torch.where(s3 > 0, s3, 1.0)
    denom = torch.where(phi != s3 * s3, phi - s3 * s3, 1.0)
    x0 = -1.0 / s3s + (2.0 * s3 + torch.sqrt(phi * phi / (s3s * s3s)
                                             + 3.0 * phi)) / denom
    t0 = -2.0 * a * logsafe(a) - 2.0 * (1.0 - a) * logsafe(1.0 - a)

    def f0(x):
        t1 = x * x
        t2 = 2.0 * x / s3s
        return (
            2.0 * a * logsafe(2.0 * a * t1 + (1.0 + a) * t2)
            + 2.0 * (1.0 - a) * logsafe(2.0 * (1.0 - a) * t1
                                        + (2.0 - a) * t2)
            - logsafe(phi)
            - logsafe(t1 + t2)
            - 2.0 * logsafe(t2)
            + t0
        )

    def f1(x):
        t1 = x * x
        t2 = x * 2.0 / s3s
        d1v = a * x + (1.0 + a) / s3s
        d1 = torch.where(d1v != 0, d1v, 1.0)
        d2v = (1.0 - a) * x + (2.0 - a) / s3s
        d2 = torch.where(d2v != 0, d2v, 1.0)
        d3 = torch.where(t1 + t2 != 0, t1 + t2, 1.0)
        return (2.0 * a * a / d1 + 2.0 * (1.0 - a) * (1.0 - a) / d2
                - 2.0 * (x + 1.0 / s3s) / d3)

    return ns.newton_raphson_onesided(x0, f0, f1)


def _gradient_primal(s, a):
    """grad f(s) through a Newton solve for g3
    (gradient_primal, coneops_powcone.jl:288-312)."""
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    s1s = torch.where(s1 != 0, s1, 1.0)
    s2s = torch.where(s2 != 0, s2, 1.0)
    phi = torch.exp(2.0 * a * logsafe(s1) + (2.0 - 2.0 * a) * logsafe(s2))

    abs_s3 = s3.abs()
    big = abs_s3 > ns.F64EPS
    g3_pos = _newton_raphson_powcone(torch.where(big, abs_s3, 1.0), phi, a)
    g3 = torch.where(big, torch.sign(s3) * g3_pos, 0.0)
    g1 = torch.where(big, -(a * g3 * s3 + 1.0 + a) / s1s, -(1.0 + a) / s1s)
    g2 = torch.where(big, -((1.0 - a) * g3 * s3 + 2.0 - a) / s2s,
                     -(2.0 - a) / s2s)
    return torch.stack([g1, g2, g3], dim=-1)


def _is_primal_feasible(s, a):
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    ok = (s1 > 0) & (s2 > 0)
    res = (torch.exp(2.0 * a * logsafe(s1) + 2.0 * (1.0 - a) * logsafe(s2))
           - s3 * s3)
    return ok & (res > 0)


def _is_dual_feasible(z, a):
    z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2]
    ok = (z1 > 0) & (z2 > 0)
    res = _phi_dual(z, a) - z3 * z3
    return ok & (res > 0)


def _barrier_dual(z, a):
    z1, z3 = z[..., 0], z[..., 2]
    feas = _is_dual_feasible(z, a)
    val = (-logsafe(_phi_dual(z, a) - z3 * z3)
           - (1.0 - a) * logsafe(z1) - a * logsafe(z[..., 1]))
    return torch.where(feas, val, ns.BIG)


def _barrier_primal(s, a):
    """f(s) = -f*(-g(s)) - 3 (coneops_powcone.jl:236-248)."""
    feas = _is_primal_feasible(s, a)
    mg = -_gradient_primal(s, a)
    val = (logsafe(_phi_dual(mg, a) - mg[..., 2] * mg[..., 2])
           + (1.0 - a) * logsafe(mg[..., 0])
           + a * logsafe(mg[..., 1])
           - 3.0)
    return torch.where(feas, val, ns.BIG)


def _higher_correction(H, z, a, ds, v):
    """3rd-order correction eta
    (higher_correction!, coneops_powcone.jl:320-404)."""
    u = ns.solve_3x3_sym(H, ds)
    u_ok = torch.isfinite(u).all(dim=-1)
    u = torch.where(u_ok[..., None], u, 0.0)

    z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2]
    z1s = torch.where(z1 != 0, z1, 1.0)
    z2s = torch.where(z2 != 0, z2, 1.0)
    phi = _phi_dual(z, a)
    psi = phi - z3 * z3
    psis = torch.where(psi != 0, psi, 1.0)

    gpsi = torch.stack([2.0 * a * phi / z1s, 2.0 * (1.0 - a) * phi / z2s,
                        -2.0 * z3], dim=-1)

    Hpsi11 = 2.0 * a * (2.0 * a - 1.0) * phi / (z1s * z1s)
    Hpsi12 = 4.0 * a * (1.0 - a) * phi / (z1s * z2s)
    Hpsi22 = 2.0 * (1.0 - a) * (1.0 - 2.0 * a) * phi / (z2s * z2s)

    u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2]
    v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2]

    dpsi_u = (gpsi * u).sum(dim=-1)
    dpsi_v = (gpsi * v).sum(dim=-1)

    Hpsi_v = torch.stack([Hpsi11 * v1 + Hpsi12 * v2,
                          Hpsi12 * v1 + Hpsi22 * v2, -2.0 * v3], dim=-1)
    u_Hpsi_v = (u * Hpsi_v).sum(dim=-1)

    coef = (u_Hpsi_v * psi - 2.0 * dpsi_u * dpsi_v) / (psis**3)
    coef2 = (4.0 * a * (2.0 * a - 1.0) * (1.0 - a) * phi
             * (u1 / z1s - u2 / z2s) * (v1 / z1s - v2 / z2s) / psis)
    inv_psi2 = 1.0 / (psis * psis)

    e1 = (coef * gpsi[..., 0] - 2.0 * (1.0 - a) * u1 * v1 / (z1s**3)
          + coef2 / z1s + Hpsi_v[..., 0] * dpsi_u * inv_psi2)
    e2 = (coef * gpsi[..., 1] - 2.0 * a * u2 * v2 / (z2s**3)
          - coef2 / z2s + Hpsi_v[..., 1] * dpsi_u * inv_psi2)
    e3 = coef * gpsi[..., 2] + Hpsi_v[..., 2] * dpsi_u * inv_psi2

    Hpsi_u = torch.stack([Hpsi11 * u1 + Hpsi12 * u2,
                          Hpsi12 * u1 + Hpsi22 * u2, -2.0 * u3], dim=-1)
    eta = (torch.stack([e1, e2, e3], dim=-1)
           + Hpsi_u * (dpsi_v * inv_psi2)[..., None]) / 2.0
    return torch.where(u_ok[..., None], eta, 0.0)


# ---------------------------------------------------------------------------
# composite-dispatch entry points (called from ops.py with its plan `p`)
# ---------------------------------------------------------------------------


def unit_init(p, batch):
    """s = z = (sqrt(1+a), sqrt(2-a), 0) (coneops_powcone.jl:36-54),
    (B, k, 3)."""
    a = p.pow_alpha
    s = torch.stack([torch.sqrt(1.0 + a), torch.sqrt(1.0 + (1.0 - a)),
                     torch.zeros_like(a)], dim=-1)
    s = s.expand((batch,) + tuple(s.shape))
    return s, s


def zero_scaling(p, batch):
    z3 = p.pow_alpha.new_zeros(batch, p.pow_idx.shape[0], 3)
    return {"pow_Hs": z3[..., None].expand(-1, -1, 3, 3).clone(),
            "pow_grad": z3.clone(),
            "pow_H": z3[..., None].expand(-1, -1, 3, 3).clone(),
            "pow_z": z3}


def update_scaling(p, s, z, mu, scaling_flag):
    a = p.pow_alpha
    zg = z[:, p.pow_idx]
    sg = s[:, p.pow_idx]
    grad, H = _dual_grad_H(zg, a)

    Hs_dual = mu[:, None, None, None] * H
    zt = _gradient_primal(sg, a)
    Hs_pd = ns.primal_dual_scaling_3x3(sg, zg, grad, zt, H)
    Hs = torch.where((scaling_flag == DUAL_ONLY)[:, None, None, None],
                     Hs_dual, Hs_pd)

    ok = (torch.isfinite(H).flatten(1).all(dim=1)
          & torch.isfinite(Hs).flatten(1).all(dim=1))
    state = {"pow_Hs": Hs, "pow_grad": grad, "pow_H": H, "pow_z": zg}
    return state, ok


def add_Hs_dense(p, state, Hmat):
    B, m, _ = Hmat.shape
    return Hmat.reshape(B, m * m).index_add(
        1, p.pow_hs_flat, state["pow_Hs"].reshape(B, -1)).reshape(B, m, m)


def mul_Hs(p, state, x, y):
    xg = x[:, p.pow_idx]
    yg = (state["pow_Hs"] * xg[:, :, None, :]).sum(dim=-1)
    return y.index_copy(1, p.pow_flat, yg.reshape(y.shape[0], -1))


def combined_ds_shift(p, state, step_z, step_s, sigma_mu, shift):
    eta = _higher_correction(state["pow_H"], state["pow_z"], p.pow_alpha,
                             step_s[:, p.pow_idx], step_z[:, p.pow_idx])
    vals = state["pow_grad"] * sigma_mu[:, None, None] - eta
    return shift.index_copy(1, p.pow_flat, vals.reshape(shift.shape[0], -1))


def step_length(p, dz, ds, z, s, alpha, settings):
    a = p.pow_alpha
    zg, dzg = z[:, p.pow_idx], dz[:, p.pow_idx]
    sg, dsg = s[:, p.pow_idx], ds[:, p.pow_idx]

    def feasible(al):
        al = al[:, None, None]
        return (_is_dual_feasible(zg + al * dzg, a).all(dim=1)
                & _is_primal_feasible(sg + al * dsg, a).all(dim=1))

    return ns.backtrack_alpha(alpha, feasible, settings)


def compute_barrier(p, z, s, dz, ds, alpha):
    a = p.pow_alpha
    al = alpha[:, None]
    zg = (z + al * dz)[:, p.pow_idx]
    sg = (s + al * ds)[:, p.pow_idx]
    return (_barrier_dual(zg, a).sum(dim=1)
            + _barrier_primal(sg, a).sum(dim=1))
