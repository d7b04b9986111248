"""Exponential cones, batched over problems and over the layout's exp
cones.

The counterpart of `cuclarabel_tpu/cones/exp.py` (reference
`src/cones/coneops_expcone.jl`): per-cone points are (B, k, 3), per-cone
scalars (B, k), per-problem scalars (B,).  The composite entry points at
the bottom take the index plan `p` of `cones/ops.py` (`p.exp_idx`, the
(k, 3) rows of each cone).

Primal cone:  s3 >= s2*exp(s1/s2), s2, s3 > 0.
Dual cone:    z3 >= -z1*exp(z2/z1 - 1), z3 > 0, z1 < 0.
Dual barrier: f*(z) = -log(z2 - z1 - z1*log(-z3/z1)) - log(-z1) - log(z3).
"""

import math

import torch

from . import nonsymmetric as ns
from .nonsymmetric import logsafe

# fixed interior unit initialization point (coneops_expcone.jl:36-52)
UNIT_PRIMAL = (-1.051383945322714, 0.556409619469370, 1.258967884768947)
UNIT_DUAL = UNIT_PRIMAL

DUAL_ONLY = 1  # must match ipm/loop.py


def _wright_omega(z):
    """Wright-Omega function: solves w + log(w) = z for z >= 1
    (coneops_expcone.jl:412-468, Serrano thesis Alg. 4)."""
    # Taylor-series init around z = 1 (valid branch z < 1 + pi)
    zm1 = z - 1.0
    w_taylor = (
        1.0
        + 0.5 * zm1
        + (1.0 / 16.0) * zm1**2
        - (1.0 / 192.0) * zm1**3
        - (1.0 / 3072.0) * zm1**4
        + (13.0 / 61440.0) * zm1**5
    )
    # asymptotic-series init for large z
    zs = torch.clamp(z, min=1.0)
    logz = torch.log(zs)
    zinv = 1.0 / zs
    q = logz * zinv
    w_asym = zs - logz + q
    q = q * zinv
    w_asym = w_asym + q * (logz / 2.0 - 1.0)
    q = q * zinv
    w_asym = w_asym + q * (logz * logz / 3.0 - 1.5 * logz + 1.0)

    w = torch.where(z < 1.0 + math.pi, w_taylor, w_asym)

    # two Santiago refinement iterations (fixed, unrolled)
    r = z - w - torch.log(torch.clamp(w, min=1e-300))
    for _ in range(2):
        wp1 = w + 1.0
        t = wp1 * (wp1 + (2.0 * r) / 3.0)
        w = w * (1.0 + (r / wp1) * (t - 0.5 * r) / (t - r))
        r = (2.0 * w * w - 8.0 * w - 1.0) / (72.0 * wp1**6) * r**4
    return w


def _sym3(H11, H12, H13, H22, H23, H33):
    """The symmetric (..., 3, 3) matrix of six (...) entries."""
    return torch.stack([
        torch.stack([H11, H12, H13], dim=-1),
        torch.stack([H12, H22, H23], dim=-1),
        torch.stack([H13, H23, H33], dim=-1),
    ], dim=-2)


def _dual_grad_H(z):
    """Gradient and Hessian of f*(z) at z (..., 3)
    (update_dual_grad_H, coneops_expcone.jl:370-399)."""
    z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2]
    l = logsafe(-z3 / torch.where(z1 != 0, z1, -1.0))  # noqa: E741
    r = -z1 * l - z1 + z2
    rs = torch.where(r != 0, r, 1.0)
    z1s = torch.where(z1 != 0, z1, -1.0)
    z3s = torch.where(z3 != 0, z3, 1.0)
    c2 = 1.0 / rs

    g1 = c2 * l - 1.0 / z1s
    g2 = -c2
    g3 = (c2 * z1 - 1.0) / z3s
    grad = torch.stack([g1, g2, g3], dim=-1)

    H11 = (rs * rs - z1 * rs + l * l * z1 * z1) / (rs * z1s * z1s * rs)
    H12 = -l / (rs * rs)
    H22 = 1.0 / (rs * rs)
    H13 = (z2 - z1) / (rs * rs * z3s)
    H23 = -z1 / (rs * rs * z3s)
    H33 = (rs * rs - z1 * rs + z1 * z1) / (rs * rs * z3s * z3s)
    return grad, _sym3(H11, H12, H13, H22, H23, H33)


def _gradient_primal(s):
    """grad f(s) at s (..., 3) (coneops_expcone.jl:288-304)."""
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    s2s = torch.where(s2 != 0, s2, 1.0)
    s3s = torch.where(s3 != 0, s3, 1.0)
    w = _wright_omega(1.0 - s1 / s2s - logsafe(s2 / s3s))
    wm1 = torch.where(w != 1.0, w - 1.0, 1.0)
    g1 = 1.0 / (wm1 * s2s)
    g2 = g1 + g1 * logsafe(w * s2 / s3s) - 1.0 / s2s
    g3 = w / ((1.0 - w) * s3s)
    return torch.stack([g1, g2, g3], dim=-1)


def _is_primal_feasible(s):
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    ok = (s3 > 0) & (s2 > 0)
    res = s2 * logsafe(s3 / torch.where(s2 > 0, s2, 1.0)) - s1
    return ok & (res > 0)


def _is_dual_feasible(z):
    z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2]
    ok = (z3 > 0) & (z1 < 0)
    res = z2 - z1 - z1 * logsafe(-z3 / torch.where(z1 < 0, z1, -1.0))
    return ok & (res > 0)


def _barrier_dual(z):
    """f*(z); +BIG when infeasible (coneops_expcone.jl:219-232)."""
    z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2]
    feas = _is_dual_feasible(z)
    l = logsafe(-z3 / torch.where(z1 < 0, z1, -1.0))  # noqa: E741
    val = -logsafe(-z3 * z1) - logsafe(z2 - z1 - z1 * l)
    return torch.where(feas, val, ns.BIG)


def _barrier_primal(s):
    """f(s) via Wright-Omega; +BIG when infeasible
    (coneops_expcone.jl:236-248)."""
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    feas = _is_primal_feasible(s)
    s2s = torch.where(s2 > 0, s2, 1.0)
    s3s = torch.where(s3 > 0, s3, 1.0)
    w = _wright_omega(torch.clamp(1.0 - s1 / s2s - logsafe(s2 / s3s),
                                  min=1.0))
    wbar = (w - 1.0) * (w - 1.0) / torch.where(w > 0, w, 1.0)
    val = -logsafe(wbar) - 2.0 * logsafe(s2) - logsafe(s3) - 3.0
    return torch.where(feas, val, ns.BIG)


def _higher_correction(H, z, ds, v):
    """3rd-order correction eta at z; u solves H u = ds
    (higher_correction!, coneops_expcone.jl:319-366).  ds = step_s,
    v = step_z."""
    u = ns.solve_3x3_sym(H, ds)
    u_ok = torch.isfinite(u).all(dim=-1)
    u = torch.where(u_ok[..., None], u, 0.0)

    z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2]
    z1s = torch.where(z1 != 0, z1, -1.0)
    z3s = torch.where(z3 != 0, z3, 1.0)

    gpsi3 = -z1 / z3s
    gpsi1 = logsafe(gpsi3)
    gpsi = torch.stack([gpsi1, torch.ones_like(z1), gpsi3], dim=-1)

    psi = z1 * gpsi1 - z1 + z2
    psis = torch.where(psi != 0, psi, 1.0)

    dpsi_u = (gpsi * u).sum(dim=-1)
    dpsi_v = (gpsi * v).sum(dim=-1)

    u1, u3 = u[..., 0], u[..., 2]
    v1, v3 = v[..., 0], v[..., 2]
    coef = (
        (u1 * (v1 / z1s - v3 / z3s) + u3 * (z1 * v3 / z3s - v1) / z3s) * psi
        - 2.0 * dpsi_u * dpsi_v
    ) / (psis**3)

    eta = coef[..., None] * gpsi
    inv_psi2 = 1.0 / (psis * psis)

    eta1 = eta[..., 0] + (
        (1.0 / psis - 2.0 / z1s) * u1 * v1 / (z1s * z1s)
        - u3 * v3 / (z3s * z3s) / psis
        + dpsi_u * inv_psi2 * (v1 / z1s - v3 / z3s)
        + dpsi_v * inv_psi2 * (u1 / z1s - u3 / z3s)
    )
    eta3 = eta[..., 2] + (
        2.0 * (z1 / psis - 1.0) * u3 * v3 / (z3s**3)
        - (u3 * v1 + u1 * v3) / (z3s * z3s) / psis
        + dpsi_u * inv_psi2 * (z1 * v3 / (z3s * z3s) - v1 / z3s)
        + dpsi_v * inv_psi2 * (z1 * u3 / (z3s * z3s) - u1 / z3s)
    )
    eta = torch.stack([eta1, eta[..., 1], eta3], dim=-1) / 2.0
    return torch.where(u_ok[..., None], eta, 0.0)


# ---------------------------------------------------------------------------
# composite-dispatch entry points (called from ops.py with its plan `p`)
# ---------------------------------------------------------------------------


def unit_init(p, batch):
    """The (B, k, 3) unit points (z, s)."""
    z = torch.tensor(UNIT_DUAL, dtype=torch.float64, device=p.exp_idx.device)
    s = torch.tensor(UNIT_PRIMAL, dtype=torch.float64,
                     device=p.exp_idx.device)
    shape = (batch,) + tuple(p.exp_idx.shape)
    return z.expand(shape), s.expand(shape)


def zero_scaling(p, batch):
    z3 = p.exp_idx.new_zeros(batch, p.exp_idx.shape[0], 3,
                             dtype=torch.float64)
    return {"exp_Hs": z3[..., None].expand(-1, -1, 3, 3).clone(),
            "exp_grad": z3.clone(),
            "exp_H": z3[..., None].expand(-1, -1, 3, 3).clone(),
            "exp_z": z3}


def update_scaling(p, s, z, mu, scaling_flag):
    """-> (state, ok (B,)); mu and scaling_flag (B,)."""
    zg = z[:, p.exp_idx]
    sg = s[:, p.exp_idx]
    grad, H = _dual_grad_H(zg)

    Hs_dual = mu[:, None, None, None] * H
    zt = _gradient_primal(sg)
    Hs_pd = ns.primal_dual_scaling_3x3(sg, zg, grad, zt, H)
    Hs = torch.where((scaling_flag == DUAL_ONLY)[:, None, None, None],
                     Hs_dual, Hs_pd)

    ok = (torch.isfinite(H).flatten(1).all(dim=1)
          & torch.isfinite(Hs).flatten(1).all(dim=1))
    state = {"exp_Hs": Hs, "exp_grad": grad, "exp_H": H, "exp_z": zg}
    return state, ok


def add_Hs_dense(p, state, Hmat):
    B, m, _ = Hmat.shape
    return Hmat.reshape(B, m * m).index_add(
        1, p.exp_hs_flat, state["exp_Hs"].reshape(B, -1)).reshape(B, m, m)


def mul_Hs(p, state, x, y):
    xg = x[:, p.exp_idx]
    yg = (state["exp_Hs"] * xg[:, :, None, :]).sum(dim=-1)
    return y.index_copy(1, p.exp_flat, yg.reshape(y.shape[0], -1))


def combined_ds_shift(p, state, step_z, step_s, sigma_mu, shift):
    eta = _higher_correction(state["exp_H"], state["exp_z"],
                             step_s[:, p.exp_idx], step_z[:, p.exp_idx])
    vals = state["exp_grad"] * sigma_mu[:, None, None] - eta
    return shift.index_copy(1, p.exp_flat, vals.reshape(shift.shape[0], -1))


def step_length(p, dz, ds, z, s, alpha, settings):
    zg, dzg = z[:, p.exp_idx], dz[:, p.exp_idx]
    sg, dsg = s[:, p.exp_idx], ds[:, p.exp_idx]

    def feasible(a):
        a = a[:, None, None]
        return (_is_dual_feasible(zg + a * dzg).all(dim=1)
                & _is_primal_feasible(sg + a * dsg).all(dim=1))

    return ns.backtrack_alpha(alpha, feasible, settings)


def compute_barrier(p, z, s, dz, ds, alpha):
    a = alpha[:, None]
    zg = (z + a * dz)[:, p.exp_idx]
    sg = (s + a * ds)[:, p.exp_idx]
    return _barrier_dual(zg).sum(dim=1) + _barrier_primal(sg).sum(dim=1)
