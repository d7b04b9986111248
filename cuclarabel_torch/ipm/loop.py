"""The IPM main loop over a batch of problems.

The counterpart of `cuclarabel_tpu/ipm/loop.py` (reference solve! loop,
`src/solver.jl:189-380`, with the homogeneous embedding that keeps the
quadratic objective), for the dense KKT backends, the host sparse
LDL^T of direct_solve_method="qdldl" (`kkt/sparse_cpu.py`), the
device sparse multifrontal (`kkt/sparse_tpu.py`, `sparse=`) and the
block-arrow KKT over row shards (`kkt/arrow.py`, `devices=`).  Layouts with
nonsymmetric cones start from the unit initialization and run the
reference's strategy ladder per problem (solver.jl:453-514): the
insufficient-progress restore, the numerical-error retry and the
small-step switch from PrimalDual to Dual scaling, and the barrier
backtrack of Dual-scaled combined steps.

The reference runs `vmap` over one `lax.while_loop`, so a finished
problem's state stays frozen while the others iterate.  Here one Python
loop runs over the whole batch: every quantity carries a leading batch
dimension, the body is computed for every problem, and its result is
committed only where the problem was still UNSOLVED before the body
(`torch.where(active, new, old)`), which is exactly the reference's
batching of its while_loop.  The loop stops when no problem is UNSOLVED;
the count of unsolved problems is one host sync per loop pass
(`run_passes`).  The result of each problem is therefore that of a solve
of that problem alone.

As in the reference (`make_solve_fn(parts=True)`), the loop comes in
pieces, `build(dev) -> (state0, loop_pass, post)`, so that a caller can
drive the passes itself: the staged batch compaction of
`parallel/batch.py` stops at a quorum and resumes the stragglers from
their mid-loop state in a narrower batch.
"""

import math
import time
from typing import Dict

import numpy as np
import torch

from ..cones import ops as cone_ops
from ..cones.layout import ConeLayout
from ..info_print import format_iteration_row
from ..kkt.dense import make_dense_kkt
from ..statuscodes import SolverStatus as S

F64EPS = float(np.finfo(np.float64).eps)
FMAX = float(np.finfo(np.float64).max)

# scaling strategy flags (PrimalDual first, like the reference)
PRIMAL_DUAL = 0
DUAL_ONLY = 1

INFO_KEYS = (
    "cost_primal",
    "cost_dual",
    "res_primal",
    "res_dual",
    "res_primal_inf",
    "res_dual_inf",
    "gap_abs",
    "gap_rel",
    "ktratio",
    "dot_bz",
    "dot_qx",
)


def _norm_scaled(w, v):
    """Per-problem overflow-safe 2-norm of w .* v (mathutils.jl:58-82):
    the inf-norm is factored out before squaring."""
    p = w * v
    if p.shape[1] == 0:  # fully presolved / unconstrained blocks
        return p.new_zeros(p.shape[0])
    scale = p.abs().amax(dim=1)
    safe = torch.where((scale > 0) & torch.isfinite(scale), scale, 1.0)
    return scale * torch.linalg.vector_norm(p / safe[:, None], dim=1)


def where_tree(c, a, b):
    """torch.where(c, a, b) over matching dicts of (B, ...) tensors, with
    c (B,) broadcast over the trailing axes."""
    if isinstance(a, dict):
        return {k: where_tree(c, a[k], b[k]) for k in a}
    return torch.where(c.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _bmv(M, v):
    return torch.bmm(M, v.unsqueeze(2)).squeeze(2)


def _rowdot(M, v):
    """M v as each row's products summed: unlike a batched cuBLAS
    product's, its per-problem rounding does not depend on the batch
    width, which stage 2 of a compacted solve changes."""
    return (M * v[:, None, :]).sum(dim=2)


def _vdot(u, v):
    return (u * v).sum(dim=1)


def run_passes(state, loop_pass, more=lambda n_unsolved: n_unsolved > 0):
    """Loop passes over `state` while more(number of UNSOLVED problems);
    that count is the one host sync of a pass."""
    while True:
        unsolved = state["status"] == int(S.UNSOLVED)
        if not more(int(unsolved.sum())):
            return state
        state = loop_pass(state, unsolved)


def make_solve_fn(layout: ConeLayout, settings, n: int, m: int, has_P: bool,
                  device=None, stream: bool = False, parts: bool = False,
                  sparse=None, devices=None):
    """Builds the batched solve function for this (layout, settings,
    dims) signature.  The returned fn maps a dict of batched tensors
    {P, q, A, b, d, dinv, e, einv, cscale, normq, normb[, t_start]
    [, ws_x, ws_s, ws_z]} (device_equilibrate's output, or the Solver's
    host-equilibrated data at B = 1) to a dict of batched results.  With
    ws_x/ws_s/ws_z (iterates in the equilibrated space) the solve starts
    warm instead of cold.  Runs on `device` (device.resolve_device: CUDA
    unless the caller passes device="cpu").  With `stream` (the
    single-problem Solver under settings.verbose) every loop pass prints
    the status row of problem 0, as the reference streams it (one host
    sync per pass); batches print none, as in the reference.  With
    parts=True returns `build(dev) -> (state0, loop_pass, post)`:
    state0() is the initial state, loop_pass(state, unsolved) one pass
    committed where `unsolved`, post(state) the results; `run_passes`
    drives the passes.

    With `sparse` (a kkt.sparse_tpu.SparseProblem) the KKT system is
    the device sparse multifrontal's and the data stay nonzero values:
    dev holds Pv (B, nnz(triu P)) and Av (B, nnz(A)) in place of P and A,
    and P x, A x and A' z are sparse products over the COO triplets
    (reference loop.py:88-97, :184-202).  direct_solve_method="qdldl"
    factors and solves on the host with the native sparse LDL^T
    (reference loop.py:98-104).

    With `devices` (the ordered shard devices of parallel/sharded.py)
    and direct_solve_method "auto" or "arrow", the KKT system is the
    block-arrow Schur complement of `kkt/arrow.py` (reference
    loop.py:105-113), one problem (B = 1): dev["A"] is a
    kkt.arrow.ShardedRows, A x and A' z run slab by slab and sum on
    devices[0] in shard order, and the cone scalings enter as the
    structured Hs tuple, never as the dense (m, m) Hs.  "arrow" without
    devices raises ValueError."""
    sym = layout.is_symmetric
    deg1 = layout.degree + 1
    st = settings
    init_scaling = (PRIMAL_DUAL if layout.allows_primal_dual_scaling
                    else DUAL_ONLY)
    hs_plan = None
    if sparse is not None:
        from ..kkt.sparse_tpu import make_sparse_tpu_kkt

        factorize, kkt_solve, _ = make_sparse_tpu_kkt(
            n, m, settings, layout, sparse, device=device)
        products = factorize.products
        hs_plan = cone_ops.sparse_hs_plan(layout)
    elif settings.direct_solve_method == "qdldl":
        from ..kkt.sparse_cpu import make_sparse_cpu_kkt

        factorize, kkt_solve = make_sparse_cpu_kkt(n, m, settings, layout,
                                                   device)
    elif devices is not None and settings.direct_solve_method in ("auto",
                                                                  "arrow"):
        from ..kkt.arrow import make_arrow_kkt

        factorize, kkt_solve = make_arrow_kkt(n, m, settings, layout,
                                              devices)
    elif settings.direct_solve_method == "arrow":
        raise ValueError("direct_solve_method='arrow' needs shard devices "
                         "(use ShardedSolver)")
    else:
        factorize, kkt_solve = make_dense_kkt(n, m, settings, layout, device)
    # backends that take the structured (diag, blk, socx, gpx) Hs tuple
    # in place of the dense (m, m) Hs (reference loop.py:117-126)
    structured_hs = getattr(factorize, "structured_hs", False)
    if structured_hs:
        hs_plan = cone_ops.sparse_hs_plan(layout)

    # multi-RHS ("pair") solves: None = auto — off on the dense backends,
    # on for the sparse multifrontal, whose level walk is paid once for
    # both columns (reference loop.py:133-147); the LP init always pairs
    # its two solves when the backend offers it
    pair_on = (st.kkt_pair_solve if st.kkt_pair_solve is not None
               else sparse is not None)
    kkt_solve_pair = getattr(kkt_solve, "pair", None) if pair_on else None
    init_pair = getattr(kkt_solve, "pair", None)
    has_time_limit = math.isfinite(st.time_limit)
    # the Gondzio correctors retarget a product that only symmetric
    # cones have (reference loop.py:727-729)
    n_corr = int(st.centrality_correctors) if sym else 0

    def build(dev: Dict[str, torch.Tensor]):
        q, b = dev["q"], dev["b"]
        d, dinv = dev["d"], dev["dinv"]
        e, einv = dev["e"], dev["einv"]
        cinv = 1.0 / dev["cscale"]
        normq, normb = dev["normq"], dev["normb"]
        B = q.shape[0]
        if structured_hs:
            P, A = dev["P"], dev["A"]  # A: kkt.arrow.ShardedRows

            def Amv(v):
                return A.mv(v)

            def ATmv(v):
                return A.rmv(v)

            def Pmv_data(v):
                return _bmv(P, v)

            def kkt_factorize(scal):
                return factorize(P, A, cone_ops.sparse_hs_values(
                    layout, scal, hs_plan, B, q.device))
        elif sparse is None:
            P, A = dev["P"], dev["A"]
            AT = A.transpose(1, 2)
            # exp-cone iterates amplify a rounding difference about
            # tenfold an iteration, so nonsymmetric layouts take the
            # products whose rounding is the same at every batch width
            mv = _bmv
            if not sym:
                AT, mv = AT.contiguous(), _rowdot

            def Amv(v):
                return mv(A, v)

            def ATmv(v):
                return mv(AT, v)

            def Pmv_data(v):
                return mv(P, v)

            def kkt_factorize(scal):
                return factorize(P, A, hs_dense(scal))
        else:
            Pv, Av = dev["Pv"], dev["Av"]

            def Amv(v):
                return products.Amv(Av, v)

            def ATmv(v):
                return products.ATmv(Av, v)

            def Pmv_data(v):
                return products.Pmv(Pv, v)

            def kkt_factorize(scal):
                return factorize(Pv, Av, cone_ops.sparse_hs_values(
                    layout, scal, hs_plan, B, q.device))

        def full(v):
            return torch.full((B,), v, dtype=torch.float64, device=q.device)

        def ifull(v):
            return torch.full((B,), int(v), dtype=torch.int32,
                              device=q.device)

        if has_P:
            Pmv = Pmv_data

            def quad(u, v):
                return _vdot(u, Pmv(v))
        else:
            # P is exactly zero for LP/SOCP-form problems
            def Pmv(v):
                return torch.zeros_like(v)

            def quad(u, v):
                return u.new_zeros(u.shape[0])

        # -------------------- residuals (residuals.jl:1-37)
        def residuals(v):
            x, s_, z_, tau = v["x"], v["s"], v["z"], v["tau"]
            Px = Pmv(x)
            qx = _vdot(q, x)
            bz = _vdot(b, z_)
            sz = _vdot(s_, z_)
            xPx = _vdot(x, Px)
            rx_inf = -ATmv(z_)
            rz_inf = Amv(x) + s_
            return {
                "rx": rx_inf - Px - q * tau[:, None],
                "rz": rz_inf - b * tau[:, None],
                "rtau": qx + bz + v["kappa"] + xPx / tau,
                "rx_inf": rx_inf,
                "rz_inf": rz_inf,
                "Px": Px,
                "qx": qx,
                "bz": bz,
                "sz": sz,
                "xPx": xPx,
            }

        # -------------------- info scalars (info.jl:1-63)
        def info_update(r, v):
            tinv = 1.0 / v["tau"]
            xPx_half = r["xPx"] * tinv * tinv / 2.0
            cost_primal = (r["qx"] * tinv + xPx_half) * cinv
            cost_dual = (-r["bz"] * tinv - xPx_half) * cinv

            normx = _norm_scaled(d, v["x"])
            normz = _norm_scaled(e, v["z"]) * cinv
            norms = _norm_scaled(einv, v["s"])

            res_primal_inf = (_norm_scaled(dinv, r["rx_inf"]) * cinv
                              / torch.clamp(normz, min=1.0))
            res_dual_inf = torch.maximum(
                _norm_scaled(dinv, r["Px"]) / torch.clamp(normx, min=1.0),
                _norm_scaled(einv, r["rz_inf"])
                / torch.clamp(normx + norms, min=1.0),
            )

            normx = normx * tinv
            normz = normz * tinv
            norms = norms * tinv

            res_primal = (
                _norm_scaled(einv, r["rz"]) * tinv
                / torch.clamp(normb + normx + norms, min=1.0)
            )
            res_dual = (
                _norm_scaled(dinv, r["rx"]) * tinv * cinv
                / torch.clamp(normq + normx + normz, min=1.0)
            )

            gap_abs = torch.abs(cost_primal - cost_dual)
            gap_rel = gap_abs / torch.clamp(
                torch.minimum(cost_primal.abs(), cost_dual.abs()), min=1.0)
            return {
                "cost_primal": cost_primal,
                "cost_dual": cost_dual,
                "res_primal": res_primal,
                "res_dual": res_dual,
                "res_primal_inf": res_primal_inf,
                "res_dual_inf": res_dual_inf,
                "gap_abs": gap_abs,
                "gap_rel": gap_rel,
                "ktratio": v["kappa"] * tinv,
                "dot_bz": r["bz"],
                "dot_qx": r["qx"],
            }

        # -------------------- convergence predicate (info.jl:274-331)
        def check_convergence(info, tol_gap_abs, tol_gap_rel, tol_feas,
                              tol_infeas_abs, tol_infeas_rel, tol_ktratio,
                              solved_code, pinf_code, dinf_code):
            solved = (
                (info["ktratio"] <= 1.0)
                & ((info["gap_abs"] < tol_gap_abs)
                   | (info["gap_rel"] < tol_gap_rel))
                & (info["res_primal"] < tol_feas)
                & (info["res_dual"] < tol_feas)
            )
            kt_huge = info["ktratio"] > 1000.0 / tol_ktratio
            pinf = (
                kt_huge
                & (info["dot_bz"] < -tol_infeas_abs)
                & (info["res_primal_inf"] < -tol_infeas_rel * info["dot_bz"])
            )
            dinf = (
                kt_huge
                & ~pinf
                & (info["dot_qx"] < -tol_infeas_abs)
                & (info["res_dual_inf"] < -tol_infeas_rel * info["dot_qx"])
            )
            return torch.where(
                solved, solved_code,
                torch.where(pinf, pinf_code,
                            torch.where(dinf, dinf_code, int(S.UNSOLVED))),
            ).to(torch.int32)

        # -------------------- termination (info.jl:65-120)
        def check_termination(info, prev_info, it, elapsed):
            status = check_convergence(
                info,
                st.tol_gap_abs, st.tol_gap_rel, st.tol_feas,
                st.tol_infeas_abs, st.tol_infeas_rel, st.tol_ktratio,
                int(S.SOLVED), int(S.PRIMAL_INFEASIBLE),
                int(S.DUAL_INFEASIBLE),
            )
            # poor progress detectors
            backwards = (it > 1) & (
                (info["res_dual"] > prev_info["res_dual"])
                | (info["res_primal"] > prev_info["res_primal"])
            )
            poor_hi = (
                backwards
                & (info["ktratio"] < 100.0 * F64EPS)
                & ((prev_info["gap_abs"] < st.tol_gap_abs)
                   | (prev_info["gap_rel"] < st.tol_gap_rel))
            )
            diverging = (
                backwards
                & (info["ktratio"] < 1.0)
                & (
                    ((info["res_dual"] > 100.0 * st.tol_feas)
                     & (info["res_dual"] > 100.0 * prev_info["res_dual"]))
                    | ((info["res_primal"] > 100.0 * st.tol_feas)
                       & (info["res_primal"]
                          > 100.0 * prev_info["res_primal"]))
                )
            )
            unsolved = status == int(S.UNSOLVED)
            status = torch.where(unsolved & (poor_hi | diverging),
                                 int(S.INSUFFICIENT_PROGRESS), status)
            status = torch.where(
                (status == int(S.UNSOLVED)) & (it >= st.max_iter),
                int(S.MAX_ITERATIONS), status)
            # time limit -> MAX_TIME (info.jl:110-115)
            if elapsed > st.time_limit:
                status = torch.where(status == int(S.UNSOLVED),
                                     int(S.MAX_TIME), status)
            return status.to(torch.int32)

        # -------------------- one generic KKT step solve
        # (kktsystem.jl:135-215)
        def kkt_step(fac, x2, z2, v, scal, rhs, is_affine: bool,
                     presolved=None):
            if is_affine:
                const = v["s"]
            else:
                const = cone_ops.ds_from_dz_offset(layout, scal, rhs["s"],
                                                   v["z"])
            workz = const - rhs["z"]
            if presolved is None:
                x1, z1, ok, nir = kkt_solve(fac, rhs["x"], workz)
            else:
                # solved jointly with the constant-RHS system
                x1, z1, ok, nir = presolved

            tau, kappa = v["tau"], v["kappa"]
            xi = v["x"] / tau[:, None]
            tau_num = (
                rhs["tau"] - rhs["kappa"] / tau
                + _vdot(q, x1) + _vdot(b, z1) + 2.0 * quad(xi, x1)
            )
            xi_m = xi - x2
            tau_den = (
                kappa / tau - _vdot(q, x2) - _vdot(b, z2)
                + quad(xi_m, xi_m) - quad(x2, x2)
            )
            dtau = tau_num / tau_den
            dx = x1 + dtau[:, None] * x2
            dz = z1 + dtau[:, None] * z2
            dsv = -(cone_ops.mul_Hs(layout, scal, dz) + const)
            dkappa = -(rhs["kappa"] + kappa * dtau) / tau
            return ({"x": dx, "s": dsv, "z": dz, "tau": dtau,
                     "kappa": dkappa}, ok, nir)

        def hs_dense(scal):
            # zero cones have no scaling state and contribute Hs = 0; a
            # layout of zero cones only (or none) has an empty state
            if not scal:
                return b.new_zeros(B, m, m)
            return cone_ops.assemble_Hs_dense(layout, scal)

        # -------------------- step length (variables.jl:14-43)
        def get_step_length(v, step, scal, scaling, combined: bool):
            atau = torch.where(step["tau"] < 0, -v["tau"] / step["tau"], FMAX)
            akappa = torch.where(step["kappa"] < 0,
                                 -v["kappa"] / step["kappa"], FMAX)
            amax = torch.clamp(torch.minimum(atau, akappa), max=1.0)
            alpha = cone_ops.step_length(
                layout, scal, step["z"], step["s"], v["z"], v["s"], amax, st)
            if combined:
                alpha = alpha * st.max_step_fraction
                if not sym:
                    # barrier backtrack for Dual-scaled nonsymmetric
                    # steps (solver.jl:407-442)
                    alpha = torch.where(scaling == DUAL_ONLY,
                                        backtrack_barrier(v, step, alpha),
                                        alpha)
            return alpha

        def full_barrier(v, step, alpha):
            """variables_barrier (variables.jl:46-72), per problem."""
            a = alpha[:, None]
            cur_tau = v["tau"] + alpha * step["tau"]
            cur_kappa = v["kappa"] + alpha * step["kappa"]
            sz = _vdot(v["z"] + a * step["z"], v["s"] + a * step["s"])
            mu = (sz + cur_tau * cur_kappa) / deg1
            barrier = (deg1 * cone_ops._logsafe(mu)
                       - cone_ops._logsafe(cur_tau)
                       - cone_ops._logsafe(cur_kappa))
            return barrier + cone_ops.compute_barrier(
                layout, v["z"], v["s"], step["z"], step["s"], alpha)

        def backtrack_barrier(v, step, alpha0):
            """Shrink alpha by the backtrack step until the barrier is
            below 1, at most 50 times, per problem (reference
            loop.py:444-456); one host sync per step."""
            a = alpha0
            done = torch.zeros_like(alpha0, dtype=torch.bool)
            for _ in range(50):
                if bool(done.all()):
                    break
                ok = full_barrier(v, step, a) < 1.0
                a = torch.where(done | ok, a, st.linesearch_backtrack_step * a)
                done = done | ok
            return a

        # -------------------- initialization (solver.jl:383-404)
        def warm_start():
            """Reference loop.py:460-490 (no Clarabel counterpart): the
            user's iterates, nudged to a small strictly-interior margin
            (a fixed 1e-6 floor in the equilibrated space, where the cold
            start's margin >= 1 would erase a near-optimal point's
            centrality); tau = 1 and kappa = mu0 place the homogeneous
            embedding at that centrality."""
            def interior(vec, pd):
                min_margin, _ = cone_ops.margins(layout, vec, pd)
                shift = torch.clamp(1e-6 - min_margin, min=0.0)
                return cone_ops.scaled_unit_shift(layout, vec, shift, pd)

            s0 = interior(dev["ws_s"], cone_ops.PRIMAL)
            z0 = interior(dev["ws_z"], cone_ops.DUAL)
            mu0 = torch.clamp(_vdot(s0, z0) / deg1, min=1e-8)
            return {"x": dev["ws_x"], "s": s0, "z": z0, "tau": full(1.0),
                    "kappa": mu0}

        def default_start():
            scal0 = cone_ops.set_identity_scaling(layout, B, q.device)
            fac, _ = kkt_factorize(scal0)
            if has_P:
                # QP init (kktsystem.jl:120-128)
                x0, z0, _, _ = kkt_solve(fac, -q, b)
                s0 = -z0
            else:
                # LP init (kktsystem.jl:101-119); the two solves share
                # the factor — one 2-RHS launch if the backend offers it
                if init_pair is not None:
                    x0, ms, _, z0, _, _ = init_pair(
                        fac, torch.zeros_like(q), b, -q, torch.zeros_like(b))
                else:
                    x0, ms, _, _ = kkt_solve(fac, torch.zeros_like(q), b)
                    _, z0, _, _ = kkt_solve(fac, -q, torch.zeros_like(b))
                s0 = -ms
            s0 = cone_ops.shift_to_cone_interior(layout, s0, cone_ops.PRIMAL)
            z0 = cone_ops.shift_to_cone_interior(layout, z0, cone_ops.DUAL)
            return {"x": x0, "s": s0, "z": z0, "tau": full(1.0),
                    "kappa": full(1.0)}

        def unit_start():
            """Nonsymmetric layouts: the cones' unit points, x = 0 and
            tau = kappa = 1 (reference loop.py:519-522)."""
            z0, s0 = cone_ops.unit_initialization(layout, B, q.device)
            return {"x": torch.zeros_like(q), "s": s0, "z": z0,
                    "tau": full(1.0), "kappa": full(1.0)}

        def make_state0():
            if "ws_x" in dev:
                v0 = warm_start()
            else:
                v0 = default_start() if sym else unit_start()
            info0 = {k: full(FMAX) for k in INFO_KEYS}
            return {
                "vars": v0,
                "prev_vars": v0,
                "info": info0,
                "prev_info": info0,
                "iter": ifull(0),
                "status": ifull(S.UNSOLVED),
                "scaling": ifull(init_scaling),
                "mu": full(FMAX),
                "alpha": full(0.0),
                "sigma": full(1.0),
                "ir_count": ifull(0),
                "ir_last": ifull(0),
            }

        t_start = dev.get("t_start", time.time())

        def loop_body(s_):
            """One pass, for every problem; the caller commits it where
            the problem is still unsolved."""
            v = s_["vars"]
            scaling = s_["scaling"]

            r = residuals(v)
            mu = (r["sz"] + v["tau"] * v["kappa"]) / deg1
            info = info_update(r, v)
            elapsed = time.time() - t_start if has_time_limit else 0.0
            status = check_termination(info, s_["prev_info"], s_["iter"],
                                       elapsed)
            if stream:
                # the live status line (reference loop.py:597-629)
                row = torch.stack([
                    info["cost_primal"], info["cost_dual"], info["gap_rel"],
                    info["res_primal"], info["res_dual"], info["ktratio"],
                    mu, s_["alpha"], s_["iter"].double(),
                    s_["ir_last"].double(), scaling.double(),
                ], dim=1)[0].cpu().numpy()  # the host sync
                print(format_iteration_row(int(row[8]), row), flush=True)

            # --- insufficient-progress checkpoint (solver.jl:453-472):
            # back to the previous iterate, under Dual scaling
            if not sym:
                restore = ((status == int(S.INSUFFICIENT_PROGRESS))
                           & (scaling == PRIMAL_DUAL))
                v = where_tree(restore, s_["prev_vars"], v)
                info = where_tree(restore, s_["prev_info"], info)
                status = torch.where(restore, int(S.UNSOLVED), status)
                scaling = torch.where(restore, DUAL_ONLY, scaling)
                proceed = (status == int(S.UNSOLVED)) & ~restore
            else:
                proceed = status == int(S.UNSOLVED)

            # --- cone scaling update
            scal, scale_ok = cone_ops.update_scaling(layout, v["s"], v["z"],
                                                     mu, scaling)
            status = torch.where(proceed & ~scale_ok,
                                 int(S.NUMERICAL_ERROR), status)
            proceed = proceed & scale_ok

            it = torch.where(proceed, s_["iter"] + 1, s_["iter"])

            # --- KKT update + constant-rhs solve (kktsystem.jl:62-92)
            fac, okf = kkt_factorize(scal)

            # --- affine step (variables.jl:107-121)
            rhs_aff = {
                "x": r["rx"],
                "z": r["rz"],
                "s": cone_ops.affine_ds(layout, scal, v["s"]),
                "tau": r["rtau"],
                "kappa": v["tau"] * v["kappa"],
            }
            if kkt_solve_pair is not None:
                x2, z2, x1a, z1a, okc, nir_c = kkt_solve_pair(
                    fac, -q, b, rhs_aff["x"], v["s"] - rhs_aff["z"])
                presolved_aff = (x1a, z1a, okc, nir_c)
            else:
                x2, z2, okc, nir_c = kkt_solve(fac, -q, b)
                presolved_aff = None
            kkt_ok = okf & okc

            step_aff, oka, nir_a = kkt_step(
                fac, x2, z2, v, scal, rhs_aff, True, presolved=presolved_aff)
            kkt_ok = kkt_ok & oka

            alpha_aff = get_step_length(v, step_aff, scal, scaling,
                                        combined=False)
            sigma = (1.0 - alpha_aff) ** 3  # Mehrotra (solver.jl:446-449)
            # reduced correction on the first iteration
            # (solver.jl:305-307, variables.jl:147-151)
            mcorr = torch.where(it > 1, 1.0, alpha_aff)

            # --- combined step (variables.jl:124-162)
            sigma_mu = sigma * mu
            shift = cone_ops.combined_ds_shift(
                layout, scal, step_aff["z"] * mcorr[:, None], step_aff["s"],
                sigma_mu, v["z"])
            rhs_comb = {
                "x": (1.0 - sigma)[:, None] * r["rx"],
                "z": (1.0 - sigma)[:, None] * r["rz"],
                "s": rhs_aff["s"] + shift,
                "tau": (1.0 - sigma) * r["rtau"],
                "kappa": -sigma_mu
                + mcorr * step_aff["tau"] * step_aff["kappa"]
                + v["tau"] * v["kappa"],
            }
            step_comb, okcb, nir_b = kkt_step(fac, x2, z2, v, scal, rhs_comb,
                                              False)
            kkt_ok = kkt_ok & okcb

            # --- Gondzio multiple centrality correctors (optional; no
            # reference counterpart, reference loop.py:720-770)
            if n_corr > 0:
                alpha_cc = get_step_length(v, step_comb, scal, scaling,
                                           combined=True)
                for _ in range(n_corr):
                    abar = torch.clamp(1.08 * alpha_cc + 0.08, max=1.0)
                    z_t = v["z"] + abar[:, None] * step_comb["z"]
                    s_t = v["s"] + abar[:, None] * step_comb["s"]
                    lo = st.corrector_beta_min * sigma_mu
                    hi = st.corrector_beta_max * sigma_mu
                    cadd = cone_ops.centrality_correction(
                        layout, scal, z_t, s_t, lo, hi)
                    tk = (v["tau"] + abar * step_comb["tau"]) * (
                        v["kappa"] + abar * step_comb["kappa"])
                    rhs_try = dict(rhs_comb)
                    rhs_try["s"] = rhs_comb["s"] + cadd
                    rhs_try["kappa"] = rhs_comb["kappa"] + (
                        tk - torch.clamp(tk, lo, hi))
                    step_try, okt, nir_t = kkt_step(
                        fac, x2, z2, v, scal, rhs_try, False)
                    alpha_try = get_step_length(v, step_try, scal, scaling,
                                                combined=True)
                    accept = okt & (
                        alpha_try >= alpha_cc + 0.1 * (abar - alpha_cc))
                    step_comb = where_tree(accept, step_try, step_comb)
                    rhs_comb = where_tree(accept, rhs_try, rhs_comb)
                    alpha_cc = torch.where(accept, alpha_try, alpha_cc)
                    nir_b = nir_b + torch.where(accept, nir_t, 0)

            # --- numerical-error checkpoint (solver.jl:475-489): a
            # PrimalDual-scaled nonsymmetric problem retries under Dual
            ne_fail = proceed & ~kkt_ok
            if not sym:
                ne_retry = ne_fail & (scaling == PRIMAL_DUAL)
                scaling = torch.where(ne_retry, DUAL_ONLY, scaling)
                ne_fail = ne_fail & ~ne_retry
            status = torch.where(ne_fail, int(S.NUMERICAL_ERROR), status)
            active = proceed & kkt_ok

            # --- final step length + small-step checkpoint
            # (solver.jl:337-344,492-505)
            if n_corr > 0:
                alpha = alpha_cc
            else:
                alpha = get_step_length(v, step_comb, scal, scaling,
                                        combined=True)
            if not sym:
                # a small PrimalDual step retries under Dual, uncommitted
                small_switch = (active & (scaling == PRIMAL_DUAL)
                                & (alpha < st.min_switch_step_length))
                scaling = torch.where(small_switch, DUAL_ONLY, scaling)
                active = active & ~small_switch
            small_fail = active & (
                alpha <= max(0.0, st.min_terminate_step_length))
            status = torch.where(small_fail, int(S.INSUFFICIENT_PROGRESS),
                                 status)

            commit = active & ~small_fail

            # --- commit step (variables.jl:92-104) + save prev iterate
            new_vars = {
                "x": v["x"] + alpha[:, None] * step_comb["x"],
                "s": v["s"] + alpha[:, None] * step_comb["s"],
                "z": v["z"] + alpha[:, None] * step_comb["z"],
                "tau": v["tau"] + alpha * step_comb["tau"],
                "kappa": v["kappa"] + alpha * step_comb["kappa"],
            }
            nir = (nir_c + nir_a + nir_b).to(torch.int32)
            return {
                "vars": where_tree(commit, new_vars, v),
                "prev_vars": where_tree(commit, v, s_["prev_vars"]),
                "info": info,
                "prev_info": where_tree(commit, info, s_["prev_info"]),
                "iter": it.to(torch.int32),
                "status": status.to(torch.int32),
                "scaling": scaling.to(torch.int32),
                "mu": mu,
                "alpha": torch.where(commit, alpha, 0.0),
                "sigma": sigma,
                # every refinement pass of the whole solve
                "ir_count": s_["ir_count"] + nir,
                "ir_last": nir,
            }

        # -------------------- post-processing
        def post(final):
            info = final["info"]
            status = final["status"]

            # "almost" convergence on errored / limit exits
            # (info.jl:198-214)
            errored_or_limit = (
                (status == int(S.NUMERICAL_ERROR))
                | (status == int(S.INSUFFICIENT_PROGRESS))
                | (status == int(S.MAX_ITERATIONS))
                | (status == int(S.MAX_TIME))
            )
            almost = check_convergence(
                info,
                st.reduced_tol_gap_abs, st.reduced_tol_gap_rel,
                st.reduced_tol_feas,
                st.reduced_tol_infeas_abs, st.reduced_tol_infeas_rel,
                st.reduced_tol_ktratio,
                int(S.ALMOST_SOLVED),
                int(S.ALMOST_PRIMAL_INFEASIBLE),
                int(S.ALMOST_DUAL_INFEASIBLE),
            )
            status = torch.where(
                errored_or_limit & (almost != int(S.UNSOLVED)), almost,
                status).to(torch.int32)

            is_infeasible = (
                (status == int(S.PRIMAL_INFEASIBLE))
                | (status == int(S.DUAL_INFEASIBLE))
                | (status == int(S.ALMOST_PRIMAL_INFEASIBLE))
                | (status == int(S.ALMOST_DUAL_INFEASIBLE))
            )

            # unscale (variables.jl:247-275)
            v = final["vars"]
            scaleinv = torch.where(is_infeasible, 1.0 / v["kappa"],
                                   1.0 / v["tau"])
            x_out = v["x"] * d * scaleinv[:, None]
            z_out = v["z"] * e * (scaleinv * cinv)[:, None]
            s_out = v["s"] * einv * scaleinv[:, None]

            nan = float("nan")
            return {
                "x": x_out,
                "s": s_out,
                "z": z_out,
                "tau": v["tau"] * scaleinv,
                "kappa": v["kappa"] * scaleinv,
                "status": status,
                "obj_val": torch.where(is_infeasible, nan,
                                       info["cost_primal"]),
                "obj_val_dual": torch.where(is_infeasible, nan,
                                            info["cost_dual"]),
                "iterations": final["iter"],
                "r_prim": info["res_primal"],
                "r_dual": info["res_dual"],
                "res_primal_inf": info["res_primal_inf"],
                "res_dual_inf": info["res_dual_inf"],
                "gap_abs": info["gap_abs"],
                "gap_rel": info["gap_rel"],
                "ktratio": info["ktratio"],
                "mu": final["mu"],
                "step_length": final["alpha"],
                "sigma": final["sigma"],
                "ir_count": final["ir_count"],
                # terminal scaling strategy (0 = PrimalDual, 1 = Dual)
                "scaling": final["scaling"],
            }

        def loop_pass(state, unsolved):
            return where_tree(unsolved, loop_body(state), state)

        return make_state0, loop_pass, post

    def solve(dev: Dict[str, torch.Tensor]):
        make_state0, loop_pass, post = build(dev)
        return post(run_passes(make_state0(), loop_pass))

    return build if parts else solve
