"""SparseSolver: large sparse conic programs with the device
multifrontal KKT backend.

The counterpart of `cuclarabel_tpu/sparse_solver.py`.  Same semantics
as Solver (src/solver.jl:75-380 parity), but the problem data stay
sparse end to end: host-side sparse Ruiz equilibration, nonzero-value
tensors on the device, sparse products in the loop's residuals, and the
level-scheduled multifrontal factorization of kkt/sparse_device.py.
Use it when the dense path's O(N^2) memory is the binding constraint
(N = n + m beyond a few thousand).

    solver = SparseSolver(P, q, A, b, cones, device=..., **overrides)
    sol    = solver.solve()

P and A are scipy.sparse matrices (P may be None; only its upper
triangle is read).  The loop runs on the CUDA device unless the caller
passes device="cpu".

Cones: Zero/NN (diagonal Hs), SOC (dense blocks to dim 4, rank-2
sparse expansion above), exp/pow (3x3 blocks), GenPow (rank-3
expansion), PSD (dense svec blocks — pair big cones with chordal
decomposition so blocks stay clique-sized).  Presolve and chordal
decomposition run before the pattern analysis, so both compose with the
sparse path.  Data updates reuse the symbolic analysis and the device's
index maps (memoised on the solver's `SparseProblem`)."""

import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import info_print
from . import presolve as presolve_mod
from .chordal import ChordalInfo, decomp_augment, decomp_reverse
from .cones import api
from .cones.api import cones_collapsed
from .cones.layout import build_layout
from .device import resolve_device
from .infinity import get_infinity
from .ipm.loop import make_solve_fn
from .kkt.sparse_tpu import SparseProblem, make_sparse_tpu_kkt
from .settings import Settings
from .solver import DefaultSolution
from .statuscodes import SolverStatus
from .warmstart import scale_warm_start, validate_warm_start


def sparse_ruiz_equilibrate(P, A, q, b, layout, settings):
    """Sparse mirror of equilibration.ruiz_equilibrate
    (data_equilibrate!, problemdata.jl:133-221).  P upper-symmetric
    scipy matrix or None, A scipy sparse.  Returns scaled copies +
    (d, e, c)."""
    import scipy.sparse as sp

    n = A.shape[1]
    m = A.shape[0]
    A = sp.csc_matrix(A, copy=True).astype(np.float64)
    P = (
        sp.csc_matrix((n, n))
        if P is None
        else sp.csc_matrix(P, copy=True).astype(np.float64)
    )
    P = sp.triu(P) + sp.triu(P, 1).T
    q = np.asarray(q, dtype=np.float64).copy()
    b = np.asarray(b, dtype=np.float64).copy()

    d = np.ones(n)
    e = np.ones(m)
    c = 1.0

    if settings.equilibrate_enable:
        smin = settings.equilibrate_min_scaling
        smax = settings.equilibrate_max_scaling

        def colmax(M):
            M = sp.csc_matrix(abs(M))
            out = np.zeros(M.shape[1])
            if M.nnz:
                nonempty = np.diff(M.indptr) > 0
                starts = M.indptr[:-1][nonempty]
                out[nonempty] = np.maximum.reduceat(M.data, starts)
            return out

        for _ in range(settings.equilibrate_max_iter):
            cP = colmax(P)
            cA = colmax(A)
            rA = colmax(A.T)
            dwork = np.maximum(cP, cA)
            dwork = 1.0 / np.sqrt(np.where(dwork == 0.0, 1.0, dwork))
            ework = 1.0 / np.sqrt(np.where(rA == 0.0, 1.0, rA))
            dwork = np.clip(dwork, smin / d, smax / d)
            ework = np.clip(ework, smin / e, smax / e)

            Dw = sp.diags(dwork)
            Ew = sp.diags(ework)
            P = Dw @ P @ Dw
            A = Ew @ A @ Dw
            q *= dwork
            b *= ework
            d *= dwork
            e *= ework

            mean_col_P = colmax(P).mean() if P.nnz else 0.0
            inf_q = np.abs(q).max() if n else 0.0
            if mean_col_P != 0.0 and inf_q != 0.0:
                ctmp = 1.0 / max(max(inf_q, mean_col_P), 1e-300)
                ctmp = np.clip(ctmp, smin / c, smax / c)
                P = P * ctmp
                q *= ctmp
                c *= ctmp

        # cone rectification: non-elementwise cones get their rows'
        # scalings replaced by the block mean (rectify_equilibration!,
        # coneops_defaults.jl:32-44)
        rect = layout.rectification_ranges()
        if rect:
            delta = np.ones(m)
            for lo, hi in rect:
                delta[lo:hi] = e[lo:hi].mean() / e[lo:hi]
            A = sp.diags(delta) @ A
            b *= delta
            e *= delta
    return P, A, q, b, d, e, c


class SparseSolver:
    """min (1/2)x'Px + q'x  s.t.  Ax + s = b, s in K, with P, A scipy
    sparse (every cone class)."""

    def __init__(self, P, q, A, b, cones: Sequence[api.SupportedCone],
                 settings: Optional[Settings] = None, device=None,
                 **kwargs):
        import scipy.sparse as sp

        settings = settings or Settings()
        if kwargs:
            settings = settings.replace(**kwargs)
        settings.validate()
        self.settings = settings
        self.device = resolve_device(device)

        q = np.asarray(q, dtype=np.float64).ravel()
        b = np.asarray(b, dtype=np.float64).ravel()
        n, m = q.shape[0], b.shape[0]
        if A.shape != (m, n):
            raise ValueError("A shape inconsistent with q/b")

        cones = cones_collapsed(list(cones))
        # presolve (presolver.jl): runs BEFORE pattern analysis, so the
        # sparse path supports it like the dense one; data updates are
        # then forbidden (check_data_update_allowed semantics)
        infbound = get_infinity()
        self.presolver = presolve_mod.try_presolve(cones, b, settings,
                                                   infbound)
        if self.presolver is not None:
            A = sp.csr_matrix(A)[self.presolver.keep]
            b = b[self.presolver.keep]
            _, _, cones = presolve_mod.apply_presolve(
                self.presolver, np.zeros((self.presolver.mfull, 0)),
                np.zeros(self.presolver.mfull), cones)
            m = b.shape[0]

        # chordal decomposition of PSD cones (problemdata.jl:40-45):
        # big chordally-sparse PSD blocks become many clique-sized PSD
        # cones, which enter the multifrontal KKT as small dense Hs
        # blocks.  The graph analysis and augmentation run host-side on
        # a temporarily densified copy (setup-only cost).
        self.chordal_info = None
        if settings.chordal_decomposition_enable and any(
                isinstance(c, api.PSDTriangleConeT) for c in cones):
            Ad = sp.csc_matrix(A).toarray()
            info = ChordalInfo(Ad, b, cones, settings)
            if info.is_decomposed():
                Pd = (sp.csc_matrix(P).toarray() if P is not None
                      else np.zeros((n, n)))
                Pd, q, Ad, b, cones = decomp_augment(info, Pd, q, Ad, b,
                                                     settings)
                n = q.shape[0]
                m = b.shape[0]
                P = sp.csc_matrix(Pd) if np.any(Pd) else None
                A = sp.csc_matrix(Ad)
                self.chordal_info = info

        self.layout = build_layout(tuple(cones))
        self._cones = list(cones)
        if self.layout.m != m:
            raise ValueError("cone dimensions inconsistent with b")

        b = np.minimum(b, get_infinity())
        normq = float(np.abs(q).max()) if n else 0.0
        normb = float(np.abs(b).max()) if m else 0.0

        Ps, As, qs, bs, d, e, c = sparse_ruiz_equilibrate(
            P, A, q, b, self.layout, settings)
        if settings.input_sparse_dropzeros:
            # drop explicit zeros from the stored pattern
            # (input_sparse_dropzeros, problemdata.jl:64-70); data
            # updates then require the reduced pattern
            Ps.eliminate_zeros()
            As.eliminate_zeros()
        self._has_P = bool(Ps.nnz)
        self.n, self.m = n, m
        self._d, self._e, self._c = d, e, c
        self._sp = SparseProblem.from_scipy(Ps if self._has_P else None, As)
        self._dev = {
            "Pv": self._put(self._sp.P_vals(Ps if self._has_P else None)),
            "Av": self._put(self._sp.A_vals(As)),
            "q": self._put(qs),
            "b": self._put(bs),
            "d": self._put(d),
            "dinv": self._put(1.0 / d),
            "e": self._put(e),
            "einv": self._put(1.0 / e),
            "cscale": self._put(c),
            "normq": self._put(normq),
            "normb": self._put(normb),
        }
        # the symbolic analysis and the device's index maps, once
        self._factorize, _, _ = make_sparse_tpu_kkt(
            n, m, settings, self.layout, self._sp, device=self.device)
        self._solve_fn = make_solve_fn(
            self.layout, settings, n, m, self._has_P, self.device,
            stream=settings.verbose, sparse=self._sp)
        self.solution: Optional[DefaultSolution] = None
        self.info: Optional[dict] = None

    def _put(self, x) -> torch.Tensor:
        """A host array or scalar as a batch-of-one f64 tensor on the
        solver's device."""
        a = np.asarray(x, dtype=np.float64)[None]
        return torch.tensor(a, dtype=torch.float64, device=self.device)

    # -- parametric data updating (src/data_updating.jl semantics; the
    # sparse path reuses the symbolic factorization and the index maps,
    # so re-solves skip the analysis) ----------------------------------
    def _check_update_allowed(self):
        if self.presolver is not None:
            raise ValueError(
                "Data updates not allowed if presolver is active.")
        if self.chordal_info is not None:
            raise ValueError(
                "Data updates not allowed after chordal decomposition.")

    def _vals_for_pattern(self, M, rows, cols, what):
        import scipy.sparse as sp

        C = sp.coo_matrix(M)
        got = {(int(r), int(c)): float(v)
               for r, c, v in zip(C.row, C.col, C.data)}
        want = set(zip(rows.tolist(), cols.tolist()))
        # explicit zeros outside the stored pattern are structurally
        # irrelevant (scipy products routinely carry them)
        extra = {k for k in (set(got) - want) if got[k] != 0.0}
        if extra:
            raise ValueError(
                f"{what}: sparsity pattern must match the original "
                f"(unexpected entries, e.g. {sorted(extra)[:3]})")
        return np.asarray(
            [got.get((int(r), int(c)), 0.0) for r, c in zip(rows, cols)])

    def update_P(self, P) -> None:
        """P_int = c * D P D on the stored upper pattern
        (update_P!, data_updating.jl:56-71)."""
        import scipy.sparse as sp

        if P is None:
            return
        self._check_update_allowed()
        if not self._has_P:
            raise ValueError("cannot update P: problem was built without P")
        Pu = sp.triu(sp.csc_matrix(P))
        vals = self._vals_for_pattern(Pu, self._sp.P_rows, self._sp.P_cols,
                                      "P")
        d, c = self._d, self._c
        self._dev["Pv"] = self._put(
            c * d[self._sp.P_rows] * d[self._sp.P_cols] * vals)

    def update_A(self, A) -> None:
        """A_int = E A D (update_A!, data_updating.jl:85-100)."""
        if A is None:
            return
        self._check_update_allowed()
        vals = self._vals_for_pattern(A, self._sp.A_rows, self._sp.A_cols,
                                      "A")
        self._dev["Av"] = self._put(
            self._e[self._sp.A_rows] * self._d[self._sp.A_cols] * vals)

    def update_q(self, q) -> None:
        if q is None:
            return
        self._check_update_allowed()
        q = np.asarray(q, dtype=np.float64).ravel()
        if q.shape[0] != self.n:
            raise ValueError("q: wrong length")
        self._dev["q"] = self._put(self._c * self._d * q)
        self._dev["normq"] = self._put(float(np.abs(q).max()) if self.n
                                       else 0.0)

    def update_b(self, b) -> None:
        if b is None:
            return
        self._check_update_allowed()
        b = np.asarray(b, dtype=np.float64).ravel()
        if b.shape[0] != self.m:
            raise ValueError("b: wrong length")
        b = np.minimum(b, get_infinity())
        self._dev["b"] = self._put(self._e * b)
        self._dev["normb"] = self._put(float(np.abs(b).max()) if self.m
                                       else 0.0)

    def update_data(self, P=None, q=None, A=None, b=None) -> None:
        self.update_P(P)
        self.update_q(q)
        self.update_A(A)
        self.update_b(b)

    def solve(self, warm_start=None) -> DefaultSolution:
        """warm_start=(x, s, z): seed the IPM from a prior solution
        (original problem space; symmetric-cone layouts without
        presolve/chordal reductions) — see Solver.solve."""
        dev = dict(self._dev)
        if warm_start is not None:
            self._check_update_allowed()
            wx, ws, wz = validate_warm_start(self.layout, warm_start,
                                             self.n, self.m)
            for k, v in zip(("ws_x", "ws_s", "ws_z"),
                            scale_warm_start(wx, ws, wz, self._d, self._e,
                                             self._c)):
                dev[k] = self._put(v)

        if self.settings.verbose:
            info_print.print_banner(self.settings)
            info_print.print_configuration(
                self.settings, self.n, self.m, self._cones, self._has_P,
                "sparse multifrontal")
            info_print.print_iteration_header()
        if math.isfinite(self.settings.time_limit):
            dev["t_start"] = time.time()
        t0 = time.perf_counter()
        out = {k: v[0].cpu().numpy() for k, v in self._solve_fn(dev).items()}
        solve_time = time.perf_counter() - t0

        self.info = dict(out)
        self.info["solve_time"] = solve_time
        # linear-solver block (reference DefaultInfo linear_solver,
        # types.jl:209-251): the multifrontal backend's symbolic stats
        ls = dict(self._factorize.linear_solver_info)
        ls["nnzA"] = int(self._sp.A_rows.shape[0])
        self.info["linear_solver"] = ls
        x_out, s_out, z_out = out["x"], out["s"], out["z"]
        # reverse chordal decomposition (solution.jl:30-34), then
        # reverse presolve — same order as the dense Solver
        if self.chordal_info is not None:
            x_out, s_out, z_out = decomp_reverse(
                self.chordal_info, x_out, s_out, z_out, self.settings)
        if self.presolver is not None:
            s_out, z_out = presolve_mod.reverse_presolve(
                self.presolver, s_out, z_out)
        self.solution = DefaultSolution(
            x=x_out,
            z=z_out,
            s=s_out,
            status=SolverStatus(int(out["status"])),
            obj_val=float(out["obj_val"]),
            obj_val_dual=float(out["obj_val_dual"]),
            solve_time=solve_time,
            iterations=int(out["iterations"]),
            r_prim=float(out["r_prim"]),
            r_dual=float(out["r_dual"]),
        )
        if self.settings.verbose:
            info_print.print_footer(self.solution)
        return self.solution

    def get_solution(self) -> Optional[DefaultSolution]:
        return self.solution

    def get_info(self) -> Optional[dict]:
        return self.info
