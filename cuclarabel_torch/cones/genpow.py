"""Generalised power cones, batched over problems and over a padded
block of the layout's cones.

The counterpart of `cuclarabel_tpu/cones/genpow.py` (reference
`src/cones/coneops_genpowcone.jl`).  Cones are padded to (k, d1max) and
(k, d2max) index blocks (`cones/layout.py`); padded gather slots point at
the cone's own first element and are masked out of every reduction, and
scatters add zeros there.  Per-cone values are (B, k, d), per-problem
scalars (B,).  The entry points take the index plan `p` of
`cones/ops.py` (`p.gp_*`).

Primal cone: prod_i s_i^{a_i} >= ||w||, s_i >= 0  (s = (u, w)).
Dual cone:   prod_i (z_i/a_i)^{a_i} >= ||w||, z_i >= 0.
Dual barrier: f*(z) = -log(prod (z_i/a_i)^{2a_i} - ||w||^2)
              - sum (1-a_i) log z_i.

The cone is dual-scaling only (`coneops_genpowcone.jl:21`); Hs is the
rank-3 form mu (D + pp' - qq' - rr'), which the dense KKT backend takes
as a dense block.
"""

import torch

from . import nonsymmetric as ns
from .nonsymmetric import logsafe


def _gather(p, v):
    """Padded (B, k, d1max), (B, k, d2max) views of a (B, m) vector."""
    return v[:, p.gp_idx1], v[:, p.gp_idx2]


def _scatter_add(p, full, vals1, vals2):
    """Accumulate padded per-cone values into a (B, m) vector; padding
    contributes nothing.  Only the unpadded entries are added, whose
    targets are distinct, so each target takes one addition and the
    result does not depend on the order of the card's atomic adds (the
    padded indices alias the cone's first element)."""
    B = full.shape[0]
    v1 = vals1.expand(B, -1, -1).reshape(B, -1)[:, p.gp_pos1]
    v2 = vals2.expand(B, -1, -1).reshape(B, -1)[:, p.gp_pos2]
    return full.index_add(1, p.gp_tgt1, v1).index_add(1, p.gp_tgt2, v2)


def _phi_dual(p, u):
    """prod_i (u_i/a_i)^(2 a_i) over masked entries, (B, k)."""
    a = p.gp_alpha
    terms = 2.0 * a * logsafe(u / torch.where(a > 0, a, 1.0))
    return torch.exp(torch.where(p.gp_mask1, terms, 0.0).sum(dim=-1))


def _phi_primal(p, u):
    """prod_i u_i^(2 a_i) over masked entries."""
    terms = 2.0 * p.gp_alpha * logsafe(u)
    return torch.exp(torch.where(p.gp_mask1, terms, 0.0).sum(dim=-1))


def _norm2w(p, w):
    return torch.where(p.gp_mask2, w * w, 0.0).sum(dim=-1)


def _positive(p, u):
    return torch.where(p.gp_mask1, u > 0, True).all(dim=-1)


def _is_primal_feasible(p, u, w):
    res = _phi_primal(p, u) - _norm2w(p, w)
    return _positive(p, u) & (res > 0)


def _is_dual_feasible(p, u, w):
    res = _phi_dual(p, u) - _norm2w(p, w)
    return _positive(p, u) & (res > 0)


def _barrier_dual(p, u, w):
    a = p.gp_alpha
    feas = _is_dual_feasible(p, u, w)
    res = _phi_dual(p, u) - _norm2w(p, w)
    val = -logsafe(res) - torch.where(
        p.gp_mask1, (1.0 - a) * logsafe(u), 0.0).sum(dim=-1)
    return torch.where(feas, val, ns.BIG)


def _newton_raphson_genpow(p, norm_r, u, phi):
    """Newton-Raphson for the primal gradient root
    (_newton_raphson_genpowcone, coneops_genpowcone.jl:437-472)."""
    a = p.gp_alpha
    mask = p.gp_mask1
    psi = 1.0 / torch.where(mask, a * a, 0.0).sum(dim=-1)
    a_safe = torch.where(a > 0, a, 1.0)

    nrs = torch.where(norm_r > 0, norm_r, 1.0)
    denom = torch.where(phi != norm_r * norm_r, phi - norm_r * norm_r, 1.0)
    x0 = -1.0 / nrs + (
        psi * norm_r + torch.sqrt((phi / (nrs * nrs) + psi * psi - 1.0) * phi)
    ) / denom

    def f0(x):
        xc = x[..., None]
        t = 2.0 * a * (logsafe(xc * nrs[..., None] + (1.0 + a) / a_safe)
                       - logsafe(u))
        return (-logsafe(2.0 * x / nrs + x * x)
                + torch.where(mask, t, 0.0).sum(dim=-1))

    def f1(x):
        xc = x[..., None]
        dv = nrs[..., None] * xc + (1.0 + a) / a_safe
        t = 2.0 * a * nrs[..., None] / torch.where(dv != 0, dv, 1.0)
        quad = x * x + 2.0 * x / nrs
        quad = torch.where(quad != 0, quad, 1.0)
        return (-(2.0 * x + 2.0 / nrs) / quad
                + torch.where(mask, t, 0.0).sum(dim=-1))

    return ns.newton_raphson_onesided(x0, f0, f1)


def _gradient_primal(p, u, w):
    """grad f(s) = (gp, gr), padded (gradient_primal!,
    coneops_genpowcone.jl:393-435)."""
    a = p.gp_alpha
    us = torch.where(u != 0, u, 1.0)
    phi = _phi_primal(p, u)
    norm_r = torch.sqrt(_norm2w(p, w))

    big = norm_r > ns.F64EPS
    g1 = _newton_raphson_genpow(p, torch.where(big, norm_r, 1.0), u, phi)
    nrs = torch.where(norm_r > 0, norm_r, 1.0)

    gr = torch.where(big[..., None], g1[..., None] * w / nrs[..., None], 0.0)
    gp = torch.where(big[..., None],
                     -(1.0 + a + a * (g1 * norm_r)[..., None]) / us,
                     -(1.0 + a) / us)
    return gp, gr


def _barrier_primal(p, u, w):
    """f(s) = -f*(-g(s)) - deg (barrier_primal,
    coneops_genpowcone.jl:258-273)."""
    feas = _is_primal_feasible(p, u, w)
    gp, gr = _gradient_primal(p, u, w)
    val = -_barrier_dual(p, -gp, -gr) - p.gp_deg
    return torch.where(feas, val, ns.BIG)


# ---------------------------------------------------------------------------
# composite-dispatch entry points (called from ops.py with its plan `p`)
# ---------------------------------------------------------------------------


def unit_init(p, z, s):
    """s_i = sqrt(1 + a_i) on the alpha head, w = 0; z = s
    (unit_initialization!, coneops_genpowcone.jl:33-52)."""
    vals1 = torch.sqrt(1.0 + p.gp_alpha)
    zero2 = torch.zeros_like(p.gp_m2)
    return (_scatter_add(p, z, vals1, zero2),
            _scatter_add(p, s, vals1, zero2))


def zero_scaling(p, batch):
    k, d1 = p.gp_idx1.shape
    d2 = p.gp_idx2.shape[1]
    zeros = p.gp_alpha.new_zeros
    return {
        "gp_grad1": zeros(batch, k, d1),
        "gp_grad2": zeros(batch, k, d2),
        "gp_d1": zeros(batch, k, d1),
        "gp_d2": zeros(batch, k),
        "gp_p1": zeros(batch, k, d1),
        "gp_p2": zeros(batch, k, d2),
        "gp_q": zeros(batch, k, d1),
        "gp_r": zeros(batch, k, d2),
        "gp_mu": zeros(batch),
    }


def copy_s(p, src, dst):
    """dst[cone ranges] = src[cone ranges] (affine_ds! / offset parity)."""
    s1, s2 = _gather(p, src)
    return _scatter_add(p, dst, s1, s2)


def update_scaling(p, s, z, mu):
    """Dual gradient and Hessian factors at z (update_dual_grad_H,
    coneops_genpowcone.jl:337-389), Hs = mu (D + pp' - qq' - rr');
    -> (state, ok (B,))."""
    a = p.gp_alpha
    u, w = _gather(p, z)
    us = torch.where(u != 0, u, 1.0)

    phi = _phi_dual(p, u)
    n2w = _norm2w(p, w)
    zeta = phi - n2w
    ok = ((zeta > 0) & torch.isfinite(zeta)).all(dim=1)
    zs = torch.where(zeta > 0, zeta, 1.0)

    tau = 2.0 * a / us
    grad1 = -tau * (phi / zs)[..., None] - (1.0 - a) / us
    grad2 = 2.0 * w / zs[..., None]

    p0 = torch.sqrt(phi * (phi + n2w) / 2.0)
    p0s = torch.where(p0 > 0, p0, 1.0)
    p1 = -2.0 * phi / p0s
    q0 = torch.sqrt(zs * phi / 2.0)
    r1 = 2.0 * torch.sqrt(zs / torch.where(phi + n2w > 0, phi + n2w, 1.0))

    d1 = tau * (phi / zs)[..., None] / us + (1.0 - a) / (us * us)
    d2 = 2.0 / zs

    state = {
        "gp_grad1": grad1,
        "gp_grad2": grad2,
        "gp_d1": d1,
        "gp_d2": d2,
        "gp_p1": (p0 / zs)[..., None] * tau,
        "gp_p2": (p1 / zs)[..., None] * w,
        "gp_q": (q0 / zs)[..., None] * tau,
        "gp_r": (r1 / zs)[..., None] * w,
        "gp_mu": mu,
    }
    return state, ok


def add_Hs_dense(p, state, Hmat):
    """Fold mu (D + pp' - qq' - rr') of each cone into the dense Hs (the
    reference's sparse path appends expansion rows instead,
    directldl_datamaps.jl:81-167)."""
    B, m, _ = Hmat.shape
    zeros = Hmat.new_zeros(B, m)
    dfull = _scatter_add(p, zeros, state["gp_d1"],
                         state["gp_d2"][..., None].expand_as(state["gp_r"]))
    pfull = _scatter_add(p, zeros, state["gp_p1"], state["gp_p2"])
    qfull = _scatter_add(p, zeros, state["gp_q"],
                         torch.zeros_like(state["gp_r"]))
    rfull = _scatter_add(p, zeros, torch.zeros_like(state["gp_q"]),
                         state["gp_r"])

    def outer(v):
        return v[:, :, None] * v[:, None, :]

    rank3 = outer(pfull) - outer(qfull) - outer(rfull)
    mu = state["gp_mu"][:, None, None]
    return Hmat + mu * (torch.diag_embed(dfull) + rank3 * p.gp_same)


def mul_Hs(p, state, x, y):
    """y = mu (D + pp' - qq' - rr') x (mul_Hs!,
    coneops_genpowcone.jl:115-139)."""
    x1, x2 = _gather(p, x)
    x1, x2 = x1 * p.gp_m1, x2 * p.gp_m2

    coef_p = ((state["gp_p1"] * x1).sum(dim=-1)
              + (state["gp_p2"] * x2).sum(dim=-1))[..., None]
    coef_q = (state["gp_q"] * x1).sum(dim=-1)[..., None]
    coef_r = (state["gp_r"] * x2).sum(dim=-1)[..., None]

    y1 = (state["gp_d1"] * x1 - coef_q * state["gp_q"]
          + coef_p * state["gp_p1"])
    y2 = (state["gp_d2"][..., None] * x2 - coef_r * state["gp_r"]
          + coef_p * state["gp_p2"])
    mu = state["gp_mu"][:, None, None]
    return _scatter_add(p, y, mu * y1, mu * y2)


def combined_ds_shift(p, state, sigma_mu, shift):
    """sigma mu grad, no 3rd-order correction (combined_ds_shift!,
    coneops_genpowcone.jl:160-178)."""
    smu = sigma_mu[:, None, None]
    return _scatter_add(p, shift, smu * state["gp_grad1"],
                        smu * state["gp_grad2"])


def step_length(p, dz, ds, z, s, alpha, settings):
    zu, zw = _gather(p, z)
    dzu, dzw = _gather(p, dz)
    su, sw = _gather(p, s)
    dsu, dsw = _gather(p, ds)

    def feasible(al):
        al = al[:, None, None]
        return (_is_dual_feasible(p, zu + al * dzu, zw + al * dzw).all(dim=1)
                & _is_primal_feasible(p, su + al * dsu,
                                      sw + al * dsw).all(dim=1))

    return ns.backtrack_alpha(alpha, feasible, settings)


def compute_barrier(p, z, s, dz, ds, alpha):
    al = alpha[:, None]
    zu, zw = _gather(p, z + al * dz)
    su, sw = _gather(p, s + al * ds)
    return (_barrier_dual(p, zu, zw).sum(dim=1)
            + _barrier_primal(p, su, sw).sum(dim=1))
