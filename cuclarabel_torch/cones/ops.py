"""Batched cone operations on flat (B, m) tensors.

The counterpart of `cuclarabel_tpu/cones/ops.py`, with the reference's
names.  Every vector carries a leading batch dimension, (B, m); per-cone
scalars are (B, nsoc) and per-problem scalars (B,).  Zero / nonnegative
cones are masked elementwise ops; second-order cones run as segment sums
over the gathered (B, msoc) subvector, each added up in one fixed order
(`_seg_sum`, the kernel of `segsum.py`), so that a solve repeats to the
bit on the card, where `index_add_` adds a repeated target with atomics
in an order that changes from run to run; exponential, power,
generalised power and PSD triangle cones are dispatched to `exp.py`,
`pow.py`, `genpow.py` and `psd.py` from the composite entry points here,
as in the reference.  `sparse_hs_plan` and `sparse_hs_values` give the
sparse KKT backends (`kkt/sparse_tpu.py`) Hs as a diagonal, the entries
of its dense blocks and the columns of the SOC and generalised power
cones' low-rank expansions.
"""

import functools

import numpy as np
import torch

from . import exp as expcone
from . import genpow as gpcone
from . import pow as powcone
from . import psd as psdcone
from .layout import ConeLayout
from .segsum import Segments, segment_sum

FMAX = float(np.finfo(np.float64).max)
EPS = float(np.finfo(np.float64).eps)

PRIMAL = 0
DUAL = 1


class _Plan:
    """The layout's index plans as tensors on one device."""

    def __init__(self, layout: ConeLayout, device):
        t = functools.partial(torch.as_tensor, device=device)
        self.nn_mask = t(layout.nn_mask)
        self.zero_mask = t(layout.zero_mask)
        if layout.has_soc:
            self.soc_idx = t(layout.soc_idx.astype(np.int64))
            self.soc_seg = t(layout.soc_seg.astype(np.int64))
            self.soc_headpos = t(layout.soc_headpos.astype(np.int64))
            self.soc_is_head = t(layout.soc_is_head)
            self.soc_sign = t(layout.soc_sign, dtype=torch.float64)
            self.soc_head_full = t(layout.soc_head_full.astype(np.int64))
            self.soc_segs = Segments(layout.soc_seg, device)
            segfull = layout.soc_segfull
            self.soc_same = t((segfull[:, None] == segfull[None, :])
                              & (segfull >= 0)[:, None])
        m = layout.m
        if layout.has_exp:
            idx = layout.exp_idx.astype(np.int64)
            self.exp_idx = t(idx)
            self.exp_flat = t(idx.ravel())
            self.exp_hs_flat = t((idx[:, :, None] * m
                                  + idx[:, None, :]).ravel())
        if layout.has_pow:
            idx = layout.pow_idx.astype(np.int64)
            self.pow_idx = t(idx)
            self.pow_flat = t(idx.ravel())
            self.pow_hs_flat = t((idx[:, :, None] * m
                                  + idx[:, None, :]).ravel())
            self.pow_alpha = t(layout.pow_alpha, dtype=torch.float64)
        if layout.has_genpow:
            f64 = torch.float64
            self.gp_idx1 = t(layout.gp_idx1.astype(np.int64))
            self.gp_idx2 = t(layout.gp_idx2.astype(np.int64))
            # the unpadded entries of the flattened (k, d) blocks, and
            # their targets in the m-vector (distinct)
            for i in (1, 2):
                mask = getattr(layout, f"gp_mask{i}").ravel()
                pos = np.flatnonzero(mask)
                setattr(self, f"gp_pos{i}", t(pos))
                setattr(self, f"gp_tgt{i}", t(getattr(
                    layout, f"gp_idx{i}").astype(np.int64).ravel()[pos]))
            self.gp_mask1 = t(layout.gp_mask1)
            self.gp_mask2 = t(layout.gp_mask2)
            self.gp_m1 = t(layout.gp_mask1, dtype=f64)
            self.gp_m2 = t(layout.gp_mask2, dtype=f64)
            self.gp_alpha = t(layout.gp_alpha, dtype=f64)
            self.gp_deg = t(layout.gp_dim1, dtype=f64) + 1.0
            seg = np.full(m, -1, dtype=np.int64)
            for i in range(layout.ngp):
                seg[layout.gp_idx1[i][layout.gp_mask1[i]]] = i
                seg[layout.gp_idx2[i][layout.gp_mask2[i]]] = i
            self.gp_same = t((seg[:, None] == seg[None, :])
                             & (seg >= 0)[:, None])
        if layout.has_psd:
            self.psd_groups = [psdcone.Group(r, idx, m, device) for r, idx
                               in sorted(layout.psd_groups.items())]


@functools.lru_cache(maxsize=64)
def plan(layout: ConeLayout, device) -> _Plan:
    return _Plan(layout, torch.device(device))


def _col(a, like):
    """Per-problem scalar(s) as a (B, 1) column (a float broadcasts)."""
    return _per_problem(a, like)[:, None]


def _per_problem(a, like, dtype=None):
    """Per-problem scalar(s) as a (B,) tensor (a number broadcasts)."""
    a = torch.as_tensor(a, dtype=dtype or like.dtype, device=like.device)
    return a.expand(like.shape[0]) if a.dim() == 0 else a


def _safe(x):
    """Guard a strictly-positive denominator (result is discarded via
    `where` whenever the guard fails)."""
    return torch.where(x > 0, x, 1.0)


def _safe_nonzero(x):
    return torch.where(x != 0, x, 1.0)


def _set(x, idx, vals):
    """Out-of-place x[:, idx] = vals."""
    return x.index_copy(1, idx, vals)


def _logsafe(v):
    """log with -inf-ish for nonpositive args (mathutils.jl:12-18)."""
    return torch.where(v > 0, torch.log(torch.where(v > 0, v, 1.0)), -FMAX)


# ---------------------------------------------------------------------------
# SOC segment helpers.  All take the *gathered* (B, msoc) tensors.
# ---------------------------------------------------------------------------


def _seg_sum(layout: ConeLayout, vals):
    """Per-cone sums of the gathered (B, msoc) vals -> (B, nsoc), each
    cone's entries added in ascending order (segsum.segment_sum)."""
    return segment_sum(vals, plan(layout, vals.device).soc_segs)


def _soc_tail_sumsq(layout, vg):
    p = plan(layout, vg.device)
    return _seg_sum(layout, torch.where(p.soc_is_head, 0.0, vg * vg))


def _soc_tail_dot(layout, ug, vg):
    p = plan(layout, vg.device)
    return _seg_sum(layout, torch.where(p.soc_is_head, 0.0, ug * vg))


def _soc_full_dot(layout, ug, vg):
    return _seg_sum(layout, ug * vg)


def _soc_residual(layout, vg):
    """Per-cone v0^2 - ||v_tail||^2, computed as (v0-t)(v0+t) for
    cancellation safety (coneops_socone.jl:415-419). Returns
    (res, v0, tailnorm)."""
    p = plan(layout, vg.device)
    v0 = vg[:, p.soc_headpos]
    t = torch.sqrt(_soc_tail_sumsq(layout, vg))
    return (v0 - t) * (v0 + t), v0, t


def _soc_mul_W(layout, eta, wg, xg):
    """y = W x via the ECOS fast product (coneops_socone.jl:313-333)."""
    p = plan(layout, xg.device)
    hp, seg = p.soc_headpos, p.soc_seg
    w0 = wg[:, hp]
    x0 = xg[:, hp]
    zeta = _soc_tail_dot(layout, wg, xg)
    c = x0 + zeta / (1.0 + w0)
    yg = eta[:, seg] * (xg + c[:, seg] * wg)
    return _set(yg, hp, eta * (w0 * x0 + zeta))


def _soc_mul_Winv(layout, eta, wg, xg):
    """y = W^{-1} x (coneops_socone.jl:336-357)."""
    p = plan(layout, xg.device)
    hp, seg = p.soc_headpos, p.soc_seg
    w0 = wg[:, hp]
    x0 = xg[:, hp]
    zeta = _soc_tail_dot(layout, wg, xg)
    c = -x0 + zeta / (1.0 + w0)
    etainv = 1.0 / eta
    yg = etainv[:, seg] * (xg + c[:, seg] * wg)
    return _set(yg, hp, etainv * (w0 * x0 - zeta))


def _soc_circ(layout, ug, vg):
    """Jordan product x = u o v (coneops_socone.jl:376-391)."""
    p = plan(layout, vg.device)
    hp, seg = p.soc_headpos, p.soc_seg
    u0 = ug[:, hp]
    v0 = vg[:, hp]
    full = _soc_full_dot(layout, ug, vg)
    xg = u0[:, seg] * vg + v0[:, seg] * ug
    return _set(xg, hp, full)


# ---------------------------------------------------------------------------
# initialization / margins / shifts
# ---------------------------------------------------------------------------


def unit_initialization(layout: ConeLayout, batch: int, device):
    """Unit (central-ray) initialization of (z, s): zero: 0; NN: 1;
    SOC: e1 (coneops_*:unit_initialization!); exp, pow and genpow:
    their cone-specific interior points."""
    p = plan(layout, device)
    z = torch.zeros(batch, layout.m, dtype=torch.float64, device=device)
    if layout.has_nn:
        z = torch.where(p.nn_mask, 1.0, z)
    if layout.has_soc:
        z = _set(z, p.soc_head_full, torch.ones_like(z[:, p.soc_head_full]))
    s = z.clone()
    if layout.has_exp:
        ze, se = expcone.unit_init(p, batch)
        z = _set(z, p.exp_flat, ze.reshape(batch, -1))
        s = _set(s, p.exp_flat, se.reshape(batch, -1))
    if layout.has_pow:
        zp, sp = powcone.unit_init(p, batch)
        z = _set(z, p.pow_flat, zp.reshape(batch, -1))
        s = _set(s, p.pow_flat, sp.reshape(batch, -1))
    if layout.has_genpow:
        z, s = gpcone.unit_init(p, z, s)
    if layout.has_psd:
        z, s = psdcone.unit_init(p, z, s)
    return z, s


def margins(layout: ConeLayout, z, pd: int):
    """(min_margin, total_positive_margin) per problem, each (B,)
    (coneops_compositecone.jl:49-63)."""
    p = plan(layout, z.device)
    alpha = torch.full_like(z[:, 0], FMAX)
    beta = torch.zeros_like(z[:, 0])
    if layout.has_nn:
        zn = torch.where(p.nn_mask, z, FMAX)
        alpha = torch.minimum(alpha, zn.amin(dim=1))
        beta = beta + torch.where(p.nn_mask & (z > 0), z, 0.0).sum(dim=1)
    if layout.has_soc:
        zg = z[:, p.soc_idx]
        _, z0, t = _soc_residual(layout, zg)
        am = z0 - t
        alpha = torch.minimum(alpha, am.amin(dim=1))
        beta = beta + torch.clamp(am, min=0.0).sum(dim=1)
    if layout.has_psd:
        a_p, b_p = psdcone.margins(p, z)
        alpha = torch.minimum(alpha, a_p)
        beta = beta + b_p
    # zero cone contributes (FMAX, 0) (coneops_zerocone.jl:27-39)
    return alpha, beta


def scaled_unit_shift(layout: ConeLayout, z, alpha, pd: int):
    """z += alpha * e per cone; the zero cone is *zeroed* when shifting
    primal vectors (coneops_zerocone.jl:42-55).  alpha: (B,) or float."""
    p = plan(layout, z.device)
    a = _col(alpha, z)
    if layout.has_nn:
        z = torch.where(p.nn_mask, z + a, z)
    if layout.has_soc:
        z = z.index_add(1, p.soc_head_full, a.expand(-1, layout.nsoc))
    if layout.has_psd:
        z = psdcone.scaled_unit_shift(p, z, a)
    if layout.has_zero and pd == PRIMAL:
        z = torch.where(p.zero_mask, 0.0, z)
    return z


def shift_to_cone_interior(layout: ConeLayout, z, pd: int):
    """Two-stage interior shift used by symmetric initialization
    (variables.jl:180-208)."""
    min_margin, pos_margin = margins(layout, z, pd)
    deg = max(layout.degree, 1)
    target = torch.maximum(torch.ones_like(pos_margin), 0.1 * pos_margin / deg)

    z_neg = scaled_unit_shift(layout, z, -min_margin, pd)
    z_neg = scaled_unit_shift(layout, z_neg, target, pd)
    z_small = scaled_unit_shift(layout, z, target - min_margin, pd)
    z_ok = scaled_unit_shift(layout, z, 0.0, pd)

    cond_neg = (min_margin <= 0)[:, None]
    cond_small = ~cond_neg & (min_margin < target)[:, None]
    return torch.where(cond_neg, z_neg, torch.where(cond_small, z_small, z_ok))


# ---------------------------------------------------------------------------
# scaling updates
# ---------------------------------------------------------------------------


def set_identity_scaling(layout: ConeLayout, batch: int, device):
    """W = I scaling used to produce the symmetric initial point
    (solver.jl:388-396)."""
    p = plan(layout, device)
    f64 = torch.float64
    state = {}
    if layout.has_nn:
        one = torch.where(p.nn_mask, 1.0, 0.0).to(f64).expand(batch, -1)
        state["nn_w"] = one.clone()
        state["nn_lam"] = one.clone()
    if layout.has_soc:
        e1 = torch.where(p.soc_is_head, 1.0, 0.0).to(f64).expand(batch, -1)
        state["soc_w"] = e1.clone()
        state["soc_lam"] = e1.clone()
        state["soc_eta"] = torch.ones(batch, layout.nsoc, dtype=f64,
                                      device=device)
    if layout.has_psd:
        state.update(psdcone.identity_scaling(p, batch))
    # nonsymmetric cones never use identity scaling (their start is the
    # unit initialization)
    if layout.has_exp:
        state.update(expcone.zero_scaling(p, batch))
    if layout.has_pow:
        state.update(powcone.zero_scaling(p, batch))
    if layout.has_genpow:
        state.update(gpcone.zero_scaling(p, batch))
    return state


def update_scaling(layout: ConeLayout, s, z, mu, scaling_flag):
    """Update all cone scalings at the current iterate.  Returns
    (state, ok) with ok (B,) bool; parity with update_scaling!
    (coneops_compositecone.jl:103-120).  mu and scaling_flag (per
    problem, or one for all) matter only to nonsymmetric cones."""
    p = plan(layout, s.device)
    state = {}
    ok = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)

    if layout.has_nn:
        sv = torch.where(p.nn_mask, s, 1.0)
        zv = torch.where(p.nn_mask, z, 1.0)
        # fail fast when s, z leave the cone (the reference relies on
        # sqrt(neg) = NaN surfacing in the KKT solve)
        ok = ok & ((sv > 0) & (zv > 0)).all(dim=1)
        sz = torch.clamp(sv * zv, min=0.0)
        ratio = torch.clamp(sv / zv, min=0.0)
        state["nn_lam"] = torch.where(p.nn_mask, torch.sqrt(sz), 0.0)
        state["nn_w"] = torch.where(p.nn_mask, torch.sqrt(ratio), 0.0)

    if layout.has_soc:
        hp, seg = p.soc_headpos, p.soc_seg
        sg = s[:, p.soc_idx]
        zg = z[:, p.soc_idx]
        zres, z0, _ = _soc_residual(layout, zg)
        sres, s0, _ = _soc_residual(layout, sg)
        ok_soc = (zres > 0) & (sres > 0)
        zscale = torch.sqrt(torch.clamp(zres, min=0.0))
        sscale = torch.sqrt(torch.clamp(sres, min=0.0))
        zs = _safe(zscale)
        ss = _safe(sscale)
        eta = torch.sqrt(ss / zs)

        w = sg / ss[:, seg] + p.soc_sign * zg / zs[:, seg]
        wres, _, _ = _soc_residual(layout, w)
        ok_soc = ok_soc & (wres > 0)
        wscale = torch.sqrt(torch.clamp(wres, min=0.0))
        w = w / _safe(wscale)[:, seg]
        # force normalization of the head (coneops_socone.jl:111-113)
        w1sq = _soc_tail_sumsq(layout, w)
        w = _set(w, hp, torch.sqrt(1.0 + w1sq))

        # scaling point lambda (coneops_socone.jl:115-123)
        gamma = 0.5 * wscale
        s0n = s0 / ss
        z0n = z0 / zs
        coef_s = (gamma + z0n) / ss
        coef_z = (gamma + s0n) / zs
        denom = _safe(s0n + z0n + 2.0 * gamma)
        lam = (coef_s[:, seg] * sg + coef_z[:, seg] * zg) / denom[:, seg]
        lam = _set(lam, hp, gamma)
        lam = lam * torch.sqrt(ss * zs)[:, seg]

        state["soc_w"] = w
        state["soc_lam"] = lam
        state["soc_eta"] = eta
        ok = ok & ok_soc.all(dim=1)

    if layout.has_psd:
        st, okp = psdcone.update_scaling(p, s, z)
        state.update(st)
        ok = ok & okp

    if layout.has_nonsymmetric:
        mu = _per_problem(mu, s)
        flag = _per_problem(scaling_flag, s, torch.int32)
    if layout.has_exp:
        st, oke = expcone.update_scaling(p, s, z, mu, flag)
        state.update(st)
        ok = ok & oke
    if layout.has_pow:
        st, okp = powcone.update_scaling(p, s, z, mu, flag)
        state.update(st)
        ok = ok & okp
    if layout.has_genpow:
        st, okg = gpcone.update_scaling(p, s, z, mu)
        state.update(st)
        ok = ok & okg
    return state, ok


# ---------------------------------------------------------------------------
# Hs assembly / products
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# sparse-KKT Hs (reference ops.py:378-600)
# ---------------------------------------------------------------------------

SOC_NO_EXPANSION_MAX_SIZE = 4  # cone_types.jl:65-119


def sparse_hs_plan(layout: ConeLayout):
    """Host-side static plan for sparse-KKT Hs assembly
    (kkt/sparse_tpu.py; numpy, a copy of the reference's): coordinates
    of every Hs entry in the z block plus the gather indices needed to
    compute its value each iteration.

    Returns numpy dict:
      blk_rows/blk_cols: (r,) z-block coordinates (row <= col) of the
        dense-block entries — small SOC blocks, exp/pow 3x3 blocks and
        PSD svec blocks — ordered [small SOCs (cone, col-major upper)]
        ++ [exp] ++ [pow] ++ [PSD groups by side length];
      soc_small_*: gather plans for the SOC entries;
      socx_*: per EXPANDED SOC (dim > 4): member rows, flat w range;
    Value convention: values are the raw Hs entries; the assembly
    negates them (K z-block is -Hs), mirroring the diagonal path."""
    np_ = np
    blk_rows, blk_cols = [], []
    s_gi, s_gj, s_cone, s_sign = [], [], [], []
    socx_rows, socx_wpos, socx_cone = [], [], []
    if layout.has_soc:
        pos = 0
        for c in range(layout.nsoc):
            d = int(layout.soc_dims[c])
            rows = layout.soc_idx[pos: pos + d]
            if d <= SOC_NO_EXPANSION_MAX_SIZE:
                for j in range(d):
                    for i in range(j + 1):
                        blk_rows.append(int(rows[i]))
                        blk_cols.append(int(rows[j]))
                        s_gi.append(pos + i)
                        s_gj.append(pos + j)
                        s_cone.append(c)
                        s_sign.append(
                            0.0 if i != j else (1.0 if i == 0 else -1.0)
                        )
            else:
                socx_rows.append(np_.asarray(rows, dtype=np_.int64))
                socx_wpos.append((pos, pos + d))
                socx_cone.append(c)
            pos += d
    n_small = len(blk_rows)

    e_cone, e_a, e_b = [], [], []
    if layout.has_exp:
        for c in range(layout.nexp):
            rows = layout.exp_idx[c]
            for j in range(3):
                for i in range(j + 1):
                    blk_rows.append(int(rows[i]))
                    blk_cols.append(int(rows[j]))
                    e_cone.append(c)
                    e_a.append(i)
                    e_b.append(j)
    n_exp = len(blk_rows) - n_small
    p_cone, p_a, p_b = [], [], []
    if layout.has_pow:
        for c in range(layout.npow):
            rows = layout.pow_idx[c]
            for j in range(3):
                for i in range(j + 1):
                    blk_rows.append(int(rows[i]))
                    blk_cols.append(int(rows[j]))
                    p_cone.append(c)
                    p_a.append(i)
                    p_b.append(j)

    # PSD svec blocks (Hs = skron(RR'), dense (sd, sd) per cone): the
    # sparse path carries them exactly like the exp/pow blocks, which
    # is what makes chordally-decomposed SDPs (many small cliques)
    # sparse-KKT-able (reference: any Hs block enters the triu
    # assembly, directldl_kkt_assembly.jl:15-175)
    psd_groups_plan = []
    if layout.has_psd:
        for r in sorted(layout.psd_groups):
            idx = layout.psd_groups[r]
            k, sd = idx.shape
            a_ut, b_ut = [], []
            for jj in range(sd):
                for ii in range(jj + 1):
                    a_ut.append(ii)
                    b_ut.append(jj)
            a_ut = np_.asarray(a_ut, dtype=np_.int64)
            b_ut = np_.asarray(b_ut, dtype=np_.int64)
            for c in range(k):
                rows = idx[c]
                blk_rows.extend(int(rows[i]) for i in a_ut)
                blk_cols.extend(int(rows[j]) for j in b_ut)
            psd_groups_plan.append((
                r,
                np_.repeat(np_.arange(k), a_ut.shape[0]),
                np_.tile(a_ut, k),
                np_.tile(b_ut, k),
            ))

    gpx_rows1, gpx_rows2, gpx_cone = [], [], []
    if layout.has_genpow:
        for c in range(layout.ngp):
            d1 = int(layout.gp_dim1[c])
            rows1 = layout.gp_idx1[c, :d1].astype(np_.int64)
            mask2 = layout.gp_mask2[c]
            rows2 = layout.gp_idx2[c][mask2].astype(np_.int64)
            gpx_rows1.append(rows1)
            gpx_rows2.append(rows2)
            gpx_cone.append(c)

    ii = np_.asarray
    return {
        "blk_rows": ii(blk_rows, dtype=np_.int64),
        "blk_cols": ii(blk_cols, dtype=np_.int64),
        "soc_gi": ii(s_gi, dtype=np_.int64),
        "soc_gj": ii(s_gj, dtype=np_.int64),
        "soc_cone": ii(s_cone, dtype=np_.int64),
        "soc_sign": ii(s_sign, dtype=np_.float64),
        "exp_cone": ii(e_cone, dtype=np_.int64),
        "exp_a": ii(e_a, dtype=np_.int64),
        "exp_b": ii(e_b, dtype=np_.int64),
        "pow_cone": ii(p_cone, dtype=np_.int64),
        "pow_a": ii(p_a, dtype=np_.int64),
        "pow_b": ii(p_b, dtype=np_.int64),
        "psd_groups": psd_groups_plan,
        "socx_rows": socx_rows,
        "socx_wpos": socx_wpos,
        "socx_cone": ii(socx_cone, dtype=np_.int64),
        "gpx_rows1": gpx_rows1,
        "gpx_rows2": gpx_rows2,
        "gpx_cone": ii(gpx_cone, dtype=np_.int64),
    }


def _plan_tensors(hs_plan, device):
    """The gather indices of sparse_hs_plan's dict as tensors on one
    device, kept in the dict under "_tensors"."""
    cache = hs_plan.setdefault("_tensors", {})
    key = str(device)
    if key not in cache:
        t = {k: torch.as_tensor(hs_plan[k], device=device)
             for k in ("soc_gi", "soc_gj", "soc_cone", "soc_sign",
                       "exp_cone", "exp_a", "exp_b", "pow_cone", "pow_a",
                       "pow_b")}
        t["psd"] = [tuple(torch.as_tensor(a, device=device) for a in g[1:])
                    for g in hs_plan["psd_groups"]]
        t["socx_rows"] = [torch.as_tensor(r, device=device)
                          for r in hs_plan["socx_rows"]]
        t["gpx_rows1"] = [torch.as_tensor(r, device=device)
                          for r in hs_plan["gpx_rows1"]]
        t["gpx_rows2"] = [torch.as_tensor(r, device=device)
                          for r in hs_plan["gpx_rows2"]]
        cache[key] = t
    return cache[key]


def sparse_hs_values(layout: ConeLayout, state, hs_plan, batch: int,
                     device):
    """Per-iteration Hs values matching sparse_hs_plan's ordering, per
    problem (reference ops.py:517-600, batched over a leading B).

    Returns (diag, blk_vals, socx, gpx) where:
      diag (B, m): elementwise Hs diagonal — NN w^2 plus, on EXPANDED SOC
        rows, eta^2 * Dtilde (rank-2 form WtW = eta^2(Dt + uu' - vv'),
        coneops_socone.jl:125-151), plus mu * d on GenPow rows;
      blk_vals (B, r): raw Hs entries at (blk_rows, blk_cols);
      socx: per expanded cone (u_scaled, v_scaled, ext_diag (B, 2)) with
        the -eta^2 scaling of directldl_datamaps.jl:61-79 applied;
      gpx: per GenPow cone (q, r, p, ext_diag (B, 3)) scaled by -sqrt(mu)
        with ext diag (-1, -1, +1) (directldl_datamaps.jl:81-167).
    Every scatter here writes distinct rows, so the values do not depend
    on the order of the additions."""
    f64 = torch.float64
    t = _plan_tensors(hs_plan, device)
    diag = torch.zeros(batch, layout.m, dtype=f64, device=device)
    if layout.has_nn:
        p = plan(layout, device)
        diag = torch.where(p.nn_mask, state["nn_w"] ** 2, diag)

    vals = []
    if hs_plan["soc_gi"].size:
        eta2 = state["soc_eta"] ** 2
        w = state["soc_w"]
        e2 = eta2[:, t["soc_cone"]]
        vals.append(2.0 * e2 * w[:, t["soc_gi"]] * w[:, t["soc_gj"]]
                    - e2 * t["soc_sign"])
    if hs_plan["exp_cone"].size:
        vals.append(state["exp_Hs"][:, t["exp_cone"], t["exp_a"],
                                    t["exp_b"]])
    if hs_plan["pow_cone"].size:
        vals.append(state["pow_Hs"][:, t["pow_cone"], t["pow_a"],
                                    t["pow_b"]])
    if hs_plan["psd_groups"]:
        groups = {g.r: g for g in plan(layout, device).psd_groups}
        for (r, _, _, _), (cone_rep, a_t, b_t) in zip(hs_plan["psd_groups"],
                                                      t["psd"]):
            R = state[f"psd{r}_R"]
            Hs_g = psdcone._skron(R @ R.transpose(-1, -2), groups[r])
            vals.append(Hs_g[:, cone_rep, a_t, b_t])
    blk_vals = (torch.cat(vals, dim=1) if vals
                else torch.zeros(batch, 0, dtype=f64, device=device))

    gpx = []
    if layout.has_genpow:
        mu = state["gp_mu"]
        d1v = mu[:, None, None] * state["gp_d1"]
        d2v = mu[:, None] * state["gp_d2"]
        smu = torch.sqrt(mu)[:, None]
        ext = torch.tensor([-1.0, -1.0, 1.0], dtype=f64,
                           device=device).expand(batch, 3)
        for k, c in enumerate(hs_plan["gpx_cone"]):
            r1, r2 = t["gpx_rows1"][k], t["gpx_rows2"][k]
            nd1, nd2 = r1.shape[0], r2.shape[0]
            diag = diag.index_add(1, r1, d1v[:, c, :nd1])
            diag = diag.index_add(1, r2, d2v[:, c, None].expand(-1, nd2))
            qv = -smu * state["gp_q"][:, c, :nd1]
            rv = -smu * state["gp_r"][:, c, :nd2]
            pv = -smu * torch.cat([state["gp_p1"][:, c, :nd1],
                                   state["gp_p2"][:, c, :nd2]], dim=1)
            gpx.append((qv, rv, pv, ext))

    socx = []
    for rows, (lo, hi), c in zip(t["socx_rows"], hs_plan["socx_wpos"],
                                 hs_plan["socx_cone"]):
        eta2 = state["soc_eta"][:, c, None] ** 2       # (B, 1)
        wbar = state["soc_w"][:, lo:hi]
        wsq = (wbar * wbar).sum(dim=1, keepdim=True)
        dsc = 0.5 / wsq
        u0 = torch.sqrt(wsq - dsc)
        u1 = 2.0 * wbar[:, :1] / u0
        v1 = torch.sqrt(2.0 * (2.0 + 1.0 / wsq) / (2.0 * wsq - 1.0 / wsq))
        u = torch.cat([u0, u1 * wbar[:, 1:]], dim=1)
        vv = torch.cat([torch.zeros_like(u0), v1 * wbar[:, 1:]], dim=1)
        dt = torch.cat([dsc, torch.ones_like(wbar[:, 1:])], dim=1)
        diag = diag.index_add(1, rows, eta2 * dt)
        socx.append((-eta2 * u, -eta2 * vv, torch.cat([-eta2, eta2], dim=1)))
    return diag, blk_vals, socx, gpx


def assemble_Hs_dense(layout: ConeLayout, state):
    """The block-diagonal Hs = W'W as dense (B, m, m) for the dense KKT
    backend (get_Hs! per-cone semantics)."""
    any_t = next(iter(state.values()))
    p = plan(layout, any_t.device)
    B = any_t.shape[0]
    diag = any_t.new_zeros(B, layout.m)
    if layout.has_nn:
        diag = torch.where(p.nn_mask, state["nn_w"] ** 2, diag)
    H = torch.diag_embed(diag)

    if layout.has_soc:
        seg = p.soc_seg
        eta = state["soc_eta"]
        we = eta[:, seg] * state["soc_w"]
        wfull = _set(any_t.new_zeros(B, layout.m), p.soc_idx, we)
        H = H + 2.0 * (wfull[:, :, None] * wfull[:, None, :]) * p.soc_same
        jdiag = _set(any_t.new_zeros(B, layout.m), p.soc_idx,
                     (eta ** 2)[:, seg] * p.soc_sign)
        H = H - torch.diag_embed(jdiag)
    if layout.has_psd:
        H = psdcone.add_Hs_dense(p, state, H)
    if layout.has_exp:
        H = expcone.add_Hs_dense(p, state, H)
    if layout.has_pow:
        H = powcone.add_Hs_dense(p, state, H)
    if layout.has_genpow:
        H = gpcone.add_Hs_dense(p, state, H)
    return H


def mul_Hs(layout: ConeLayout, state, x):
    """y = Hs x without materializing Hs (mul_Hs! semantics)."""
    p = plan(layout, x.device)
    y = torch.zeros_like(x)
    if layout.has_nn:
        y = torch.where(p.nn_mask, state["nn_w"] ** 2 * x, y)
    if layout.has_soc:
        seg = p.soc_seg
        wg = state["soc_w"]
        xg = x[:, p.soc_idx]
        eta2 = state["soc_eta"] ** 2
        wx = _soc_full_dot(layout, wg, xg)
        yg = eta2[:, seg] * (2.0 * wx[:, seg] * wg - p.soc_sign * xg)
        y = _set(y, p.soc_idx, yg)
    if layout.has_psd:
        y = psdcone.mul_Hs(p, state, x, y)
    if layout.has_exp:
        y = expcone.mul_Hs(p, state, x, y)
    if layout.has_pow:
        y = powcone.mul_Hs(p, state, x, y)
    if layout.has_genpow:
        y = gpcone.mul_Hs(p, state, x, y)
    return y


# ---------------------------------------------------------------------------
# step RHS pieces
# ---------------------------------------------------------------------------


def affine_ds(layout: ConeLayout, state, s):
    """ds = lambda o lambda for symmetric cones, ds = s for nonsymmetric
    cones, 0 for the zero cone (affine_ds! per-cone semantics)."""
    p = plan(layout, s.device)
    ds = torch.zeros_like(s)
    if layout.has_nn:
        ds = torch.where(p.nn_mask, state["nn_lam"] ** 2, ds)
    if layout.has_soc:
        lam = state["soc_lam"]
        ds = _set(ds, p.soc_idx, _soc_circ(layout, lam, lam))
    if layout.has_psd:
        ds = psdcone.affine_ds(p, state, ds)
    return _copy_nonsymmetric(layout, p, s, ds)


def _copy_nonsymmetric(layout, p, src, dst):
    """dst = src on the rows of the nonsymmetric cones."""
    if layout.has_exp:
        dst = _set(dst, p.exp_flat, src[:, p.exp_flat])
    if layout.has_pow:
        dst = _set(dst, p.pow_flat, src[:, p.pow_flat])
    if layout.has_genpow:
        dst = gpcone.copy_s(p, src, dst)
    return dst


def combined_ds_shift(layout: ConeLayout, state, step_z, step_s, sigma_mu, z):
    """Mehrotra shift term for the combined step RHS.  Symmetric cones:
    shift = W^{-1} ds_aff o W dz_aff - sigma*mu*e
    (coneops_symmetric_common.jl:2-35); for NN this collapses to
    dz .* ds - sigma*mu.  Nonsymmetric cones: sigma*mu*grad f*(z) and the
    3rd-order correction (exp, pow).  sigma_mu: (B,)."""
    p = plan(layout, z.device)
    smu = _col(sigma_mu, z)
    shift = torch.zeros_like(z)
    if layout.has_nn:
        shift = torch.where(p.nn_mask, step_z * step_s - smu, shift)
    if layout.has_soc:
        zg = step_z[:, p.soc_idx]
        sg = step_s[:, p.soc_idx]
        eta = state["soc_eta"]
        wg = state["soc_w"]
        Wz = _soc_mul_W(layout, eta, wg, zg)
        Wis = _soc_mul_Winv(layout, eta, wg, sg)
        vals = _soc_circ(layout, Wis, Wz)
        vals = vals.index_add(1, p.soc_headpos, -smu.expand(-1, layout.nsoc))
        shift = _set(shift, p.soc_idx, vals)
    smu = smu[:, 0]
    if layout.has_psd:
        shift = psdcone.combined_ds_shift(p, state, step_z, step_s, smu,
                                          shift)
    if layout.has_exp:
        shift = expcone.combined_ds_shift(p, state, step_z, step_s, smu,
                                          shift)
    if layout.has_pow:
        shift = powcone.combined_ds_shift(p, state, step_z, step_s, smu,
                                          shift)
    if layout.has_genpow:
        shift = gpcone.combined_ds_shift(p, state, smu, shift)
    return shift


def centrality_correction(layout: ConeLayout, state, z_t, s_t, lo, hi):
    """Gondzio-corrector outlier term v - clip(v, lo, hi), where
    v = (W^{-T} s_t) o (W z_t) is the scaled complementarity of a trial
    point, clipped spectrally (elementwise for NN; Jordan eigenvalues for
    SOC).  Zero on zero-cone rows.  lo, hi: (B,)."""
    p = plan(layout, z_t.device)
    lo_c, hi_c = _col(lo, z_t), _col(hi, z_t)
    corr = torch.zeros_like(z_t)
    if layout.has_nn:
        vvals = s_t * z_t
        corr = torch.where(
            p.nn_mask, vvals - torch.clamp(vvals, lo_c, hi_c), corr)
    if layout.has_soc:
        hp, seg = p.soc_headpos, p.soc_seg
        zg = z_t[:, p.soc_idx]
        sg = s_t[:, p.soc_idx]
        eta = state["soc_eta"]
        wg = state["soc_w"]
        u = _soc_circ(
            layout,
            _soc_mul_Winv(layout, eta, wg, sg),
            _soc_mul_W(layout, eta, wg, zg),
        )
        # Jordan spectral decomposition u = lam+ c+ + lam- c-,
        # lam± = u0 ± ||u1||, c± = (1, ±u1/||u1||)/2
        u0 = u[:, hp]
        n1 = torch.sqrt(_soc_tail_sumsq(layout, u))
        lam_p = u0 + n1
        lam_m = u0 - n1
        dp = lam_p - torch.clamp(lam_p, lo_c, hi_c)
        dm = lam_m - torch.clamp(lam_m, lo_c, hi_c)
        tail_coef = 0.5 * (dp - dm) / _safe_nonzero(n1)
        vals = tail_coef[:, seg] * torch.where(p.soc_is_head, 0.0, u)
        vals = _set(vals, hp, 0.5 * (dp + dm))
        corr = _set(corr, p.soc_idx, vals)
    if layout.has_psd:
        corr = psdcone.centrality_correction(p, state, z_t, s_t, lo_c, hi_c,
                                             corr)
    return corr


def ds_from_dz_offset(layout: ConeLayout, state, ds, z):
    """out = W'(lambda \\ ds) for symmetric cones, out = ds for
    nonsymmetric cones, 0 for the zero cone (Delta_s_from_Delta_z_offset!
    semantics; SOC uses the numerically stable direct form,
    coneops_socone.jl:241-268)."""
    p = plan(layout, z.device)
    out = torch.zeros_like(z)
    if layout.has_nn:
        zv = _safe_nonzero(torch.where(p.nn_mask, z, 1.0))
        out = torch.where(p.nn_mask, ds / zv, out)
    if layout.has_soc:
        hp, seg = p.soc_headpos, p.soc_seg
        zg = z[:, p.soc_idx]
        dsg = ds[:, p.soc_idx]
        lam = state["soc_lam"]
        wg = state["soc_w"]
        eta = state["soc_eta"]
        resz, z0, _ = _soc_residual(layout, zg)
        lam0 = lam[:, hp]
        w0 = wg[:, hp]
        ds0 = dsg[:, hp]
        lam1ds1 = _soc_tail_dot(layout, lam, dsg)
        w1ds1 = _soc_tail_dot(layout, wg, dsg)
        c = (lam0 * ds0 - lam1ds1) / _safe_nonzero(resz)
        val = _set(-zg * c[:, seg], hp, z0 * c)
        # tail: + eta*(ds_tail + w1ds1/(1+w0) * w_tail); head: + eta*w1ds1
        addt = eta[:, seg] * (dsg + (w1ds1 / (1.0 + w0))[:, seg] * wg)
        add = torch.where(p.soc_is_head, 0.0, addt)
        add = add.index_add(1, hp, eta * w1ds1)
        val = (val + add) / _safe_nonzero(lam0)[:, seg]
        out = _set(out, p.soc_idx, val)
    if layout.has_psd:
        out = psdcone.ds_from_dz_offset(p, state, ds, out)
    return _copy_nonsymmetric(layout, p, ds, out)


# ---------------------------------------------------------------------------
# step length
# ---------------------------------------------------------------------------


def _nn_step_limit(layout, v, dv, amax):
    p = plan(layout, v.device)
    neg = p.nn_mask & (dv < 0)
    ratio = -v / torch.where(dv < 0, dv, -1.0)
    lim = torch.where(neg, ratio, _col(amax, v)).amin(dim=1)
    return torch.clamp(lim, max=FMAX)


def _soc_step_limit(layout, x, dx, amax):
    """Minimum positive root of ||x1+a y1||^2 = (x0+a y0)^2 per cone,
    with the cancellation-safe root formula
    (coneops_socone.jl:443-511)."""
    p = plan(layout, x.device)
    xg = x[:, p.soc_idx]
    yg = dx[:, p.soc_idx]
    a, y0, _ = _soc_residual(layout, yg)
    resx, x0, _ = _soc_residual(layout, xg)
    c = torch.clamp(resx, min=0.0)
    b = 2.0 * (x0 * y0 - _soc_tail_dot(layout, xg, yg))
    d = b * b - 4.0 * a * c

    # scalar-part bound
    a0 = torch.where((x0 >= 0) & (y0 < 0),
                     -x0 / torch.where(y0 < 0, y0, -1.0), FMAX)

    sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
    t = torch.where(b >= 0, -b - sqrt_d, -b + sqrt_d)
    r1 = 2.0 * c / _safe_nonzero(t)
    r2 = t / _safe_nonzero(2.0 * a)
    r1 = torch.where(r1 < 0, FMAX, r1)
    r2 = torch.where(r2 < 0, FMAX, r2)
    root = torch.minimum(r1, r2)

    cand = torch.where(
        ((a > 0) & (b > 0)) | (d < 0),
        FMAX,
        torch.where(
            a == 0,
            FMAX,
            torch.where(c == 0, torch.where(a >= 0, FMAX, torch.zeros_like(a)),
                        root),
        ),
    )
    lim = torch.clamp(torch.minimum(cand, a0).amin(dim=1), max=FMAX)
    return torch.minimum(lim, torch.as_tensor(amax, dtype=x.dtype,
                                              device=x.device))


def step_length(layout: ConeLayout, state, dz, ds, z, s, alpha_max, settings):
    """Max feasible step in all cones, per problem
    (coneops_compositecone.jl:205-243).  alpha_max: (B,).  Symmetric
    cones first; with nonsymmetric cones, back off to 1 - sqrt(eps) and
    run their backtracking searches, one alpha per problem."""
    alpha = alpha_max
    if layout.has_nn:
        alpha = torch.minimum(alpha, _nn_step_limit(layout, z, dz, alpha_max))
        alpha = torch.minimum(alpha, _nn_step_limit(layout, s, ds, alpha_max))
    if layout.has_soc:
        alpha = torch.minimum(alpha, _soc_step_limit(layout, z, dz, alpha_max))
        alpha = torch.minimum(alpha, _soc_step_limit(layout, s, ds, alpha_max))
    if layout.has_psd:
        alpha = psdcone.step_length(plan(layout, z.device), state, dz, ds,
                                    _per_problem(alpha, z))
    if layout.has_nonsymmetric:
        p = plan(layout, z.device)
        alpha = torch.clamp(_per_problem(alpha, z), max=1.0 - np.sqrt(EPS))
        if layout.has_exp:
            alpha = expcone.step_length(p, dz, ds, z, s, alpha, settings)
        if layout.has_pow:
            alpha = powcone.step_length(p, dz, ds, z, s, alpha, settings)
        if layout.has_genpow:
            alpha = gpcone.step_length(p, dz, ds, z, s, alpha, settings)
    return alpha


def compute_barrier(layout: ConeLayout, z, s, dz, ds, alpha):
    """Total barrier at (z + alpha dz, s + alpha ds) per problem, alpha
    (B,) (coneops_compositecone.jl:246-265)."""
    p = plan(layout, z.device)
    a = alpha[:, None]
    si = s + a * ds
    zi = z + a * dz
    barrier = torch.zeros_like(alpha)
    if layout.has_nn:
        barrier = barrier - torch.where(p.nn_mask, _logsafe(si * zi),
                                        0.0).sum(dim=1)
    if layout.has_soc:
        res_s, _, _ = _soc_residual(layout, si[:, p.soc_idx])
        res_z, _, _ = _soc_residual(layout, zi[:, p.soc_idx])
        good = (res_s > 0) & (res_z > 0)
        terms = torch.where(good, -0.5 * _logsafe(res_s * res_z), torch.inf)
        barrier = barrier + terms.sum(dim=1)
    if layout.has_psd:
        barrier = barrier + psdcone.compute_barrier(p, z, s, dz, ds, alpha)
    if layout.has_exp:
        barrier = barrier + expcone.compute_barrier(p, z, s, dz, ds, alpha)
    if layout.has_pow:
        barrier = barrier + powcone.compute_barrier(p, z, s, dz, ds, alpha)
    if layout.has_genpow:
        barrier = barrier + gpcone.compute_barrier(p, z, s, dz, ds, alpha)
    return barrier
