"""The public single-problem solver.

    solver = Solver(P, q, A, b, cones, settings=..., device=..., **overrides)
    sol    = solver.solve()

The counterpart of `cuclarabel_tpu/solver.py` (API parity with the
reference native interface, `src/solver.jl:75-380`).  `setup` runs on
the host: dimension checks, cone collapsing, presolve, Ruiz
equilibration and the cone layout, as in the reference.  `solve` runs
the batched IPM loop of `ipm/loop.py` at B = 1 on the solver's device:
CUDA unless the caller passes device="cpu", raising without a card.
On the card the dense KKT backend takes the hand-written LDL^T kernels
("pallas", by default at N <= 128, and at any N when asked for) or
pivoted LU ("lu", by default above 128).

Differences from the reference:
  * `Settings.host_solve` is accepted and has no effect: the reference
    moves small single solves off a TPU to the host CPU, which this port
    never does, and `get_info()["linear_solver"]["host_solve"]` is always
    False;
  * `solve(profile_dir=...)` writes a torch.profiler trace (Chrome trace
    JSON, host and device activity) where the reference writes a
    jax.profiler one;
  * exponential, power and generalised power cones run the reference's
    strategy ladder (`ipm/loop.py`); PSD cones are decomposed chordally
    after presolve (`chordal/`, with the reference's settings) and the
    solution is put back together before the presolve reverse, as in
    the reference.
"""

import contextlib
import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import info_print, json_io
from . import presolve as presolve_mod
from .chordal import ChordalInfo, decomp_augment, decomp_reverse
from .cones import api
from .cones.api import SupportedCone, cones_collapsed
from .cones.layout import build_layout
from .device import resolve_device
from .equilibration import ruiz_equilibrate
from .infinity import get_infinity
from .ipm.loop import make_solve_fn
from .kkt.dense import resolve_dd_npass, resolve_kkt_method
from .settings import Settings
from .statuscodes import SolverStatus, status_to_string
from .warmstart import scale_warm_start, validate_warm_start


@dataclasses.dataclass
class DefaultSolution:
    """User-facing results (types.jl:279-311)."""

    x: np.ndarray
    z: np.ndarray
    s: np.ndarray
    status: SolverStatus
    obj_val: float
    obj_val_dual: float
    solve_time: float
    iterations: int
    r_prim: float
    r_dual: float

    def __repr__(self):
        return (
            f">>> cuclarabel_torch - Results\n"
            f"Status: {status_to_string(self.status)}\n"
            f"Iterations: {self.iterations}\n"
            f"Objective: {self.obj_val:#.4g}\n"
            f"Solve time: {self.solve_time:.3e}s"
        )


def _to_dense(M, shape) -> np.ndarray:
    """Accept scipy.sparse or array-like, return a dense f64 ndarray;
    refuse to densify a sparse matrix past ~1 GB."""
    if M is None:
        return np.zeros(shape, dtype=np.float64)
    if hasattr(M, "toarray"):
        cells = int(shape[0]) * int(shape[1])
        if cells * 8 > 1 << 30:
            raise ValueError(
                f"refusing to densify a sparse {shape} matrix "
                f"({cells * 8 / 1e9:.1f} GB dense); use SparseSolver, which "
                "keeps the data sparse")
        out = np.asarray(M.toarray(), dtype=np.float64)
    else:
        out = np.asarray(M, dtype=np.float64)
    if out.shape != shape:
        raise ValueError(f"expected shape {shape}, got {out.shape}")
    return out


def resolve_factor_precision(settings) -> str:
    """The factor precision reported in get_info (reference
    `_resolve_factor_dtype`): "auto" means f64."""
    p = settings.kkt_factor_precision
    return "float64" if p == "auto" else p


class Solver:
    """min (1/2)x'Px + q'x  s.t.  Ax + s = b, s in K."""

    def __init__(
        self,
        P,
        q,
        A,
        b,
        cones: Sequence[SupportedCone],
        settings: Optional[Settings] = None,
        device=None,
        **kwargs,
    ):
        if settings is None:
            settings = Settings()
        if kwargs:
            settings = settings.replace(**kwargs)
        settings.validate()
        self.settings = settings
        self.device = resolve_device(device)
        self._dd_npass = resolve_dd_npass(settings)
        self.setup(P, q, A, b, cones)

    # ------------------------------------------------------------------
    def _put(self, x) -> torch.Tensor:
        """A host array or scalar as a batch-of-one f64 tensor on the
        solver's device."""
        a = np.asarray(x, dtype=np.float64)[None]
        return torch.tensor(a, dtype=torch.float64, device=self.device)

    def setup(self, P, q, A, b, cones: Sequence[SupportedCone]):
        q = np.asarray(q, dtype=np.float64).ravel()
        b = np.asarray(b, dtype=np.float64).ravel()
        n = q.shape[0]
        m = b.shape[0]

        # dimension checks (solver.jl:157-169)
        cones = list(cones)
        p = sum(api.nvars(c) for c in cones)
        A_shape = A.shape if A is not None else (m, n)
        if A_shape[0] != m:
            raise ValueError("A and b have incompatible dimensions")
        if p != m:
            raise ValueError("constraint dimensions inconsistent with cones")
        if A_shape[1] != n:
            raise ValueError("A and q have incompatible dimensions")

        Pd = _to_dense(P, (n, n))
        Ad = _to_dense(A, (m, n))
        # only the upper triangle of P is used (problemdata.jl:23-26)
        Pd = np.triu(Pd) + np.triu(Pd, 1).T
        self._has_P = bool(np.any(Pd != 0.0))

        # cone collapsing (cone_api.jl:96-153)
        cones = cones_collapsed(cones)

        # presolve (presolver.jl)
        self.timers = {"setup": {}, "solve": {}}
        t_ps = time.perf_counter()
        infbound = get_infinity()
        self.presolver = presolve_mod.try_presolve(cones, b, self.settings,
                                                   infbound)
        if self.presolver is not None:
            Ad, b, cones = presolve_mod.apply_presolve(self.presolver, Ad, b,
                                                       cones)
            m = b.shape[0]
        self.timers["setup"]["presolve"] = time.perf_counter() - t_ps

        # chordal decomposition of PSD cones (problemdata.jl:40-45)
        self.chordal_info = None
        if self.settings.chordal_decomposition_enable and any(
                isinstance(c, api.PSDTriangleConeT) for c in cones):
            t_ch = time.perf_counter()
            info = ChordalInfo(Ad, b, cones, self.settings)
            if info.is_decomposed():
                Pd, q, Ad, b, cones = decomp_augment(info, Pd, q, Ad, b,
                                                     self.settings)
                n, m = q.shape[0], b.shape[0]
                self.chordal_info = info
            self.timers["setup"]["chordal"] = time.perf_counter() - t_ch

        # cap b at INFINITY (problemdata.jl:58-62)
        b = np.minimum(b, infbound)

        self.layout = build_layout(tuple(cones))
        if self.layout.m != m:
            raise ValueError("cone dimensions inconsistent after presolve")

        # unscaled norms for relative termination criteria
        # (problemdata.jl:80-81, info.jl:14-16)
        normq = float(np.abs(q).max()) if n > 0 else 0.0
        normb = float(np.abs(b).max()) if m > 0 else 0.0

        # Ruiz equilibration, once at setup (solver.jl:131-136)
        t_eq = time.perf_counter()
        Pd, Ad, qs, bs, d, e, c = ruiz_equilibrate(
            Pd, Ad, q, b, self.layout, self.settings)
        self.timers["setup"]["equilibration"] = time.perf_counter() - t_eq

        self.n, self.m = n, m
        # scaled host copies kept for update_data and save_to_file
        self._cones = list(cones)
        self._Ps, self._As = Pd, Ad
        self._qs, self._bs = qs, bs
        self._d, self._e, self._c = d, e, c
        self._dev = {
            "P": self._put(Pd),
            "q": self._put(qs),
            "A": self._put(Ad),
            "b": self._put(bs),
            "d": self._put(d),
            "dinv": self._put(1.0 / d),
            "e": self._put(e),
            "einv": self._put(1.0 / e),
            "cscale": self._put(c),
            "normq": self._put(normq),
            "normb": self._put(normb),
        }
        self._refresh_solve_fn()
        self.solution: Optional[DefaultSolution] = None
        self.info: Optional[dict] = None
        return self

    def _refresh_solve_fn(self):
        self._solve_fn = make_solve_fn(
            self.layout, self.settings, self.n, self.m, self._has_P,
            self.device, stream=self.settings.verbose)

    # ------------------------------------------------------------------
    def solve(self, profile_dir: Optional[str] = None,
              warm_start=None) -> DefaultSolution:
        """Run the IPM.  With profile_dir set, the solve runs under
        torch.profiler (host activity, and the card's where the solver
        runs on one), which writes a Chrome trace JSON file into that
        directory: the counterpart of the reference's jax.profiler trace.
        warm_start=(x, s, z) seeds the iterates (original problem space,
        e.g. a previous DefaultSolution's fields after an update_data)
        instead of the cold start, as the reference does (no Clarabel
        counterpart); symmetric-cone problems without presolve reductions
        or chordal decomposition only."""
        dev = dict(self._dev)
        if warm_start is not None:
            self._check_update_allowed()  # the same presolve/chordal guards
            wx, ws, wz = validate_warm_start(self.layout, warm_start, self.n,
                                             self.m)
            for k, v in zip(("ws_x", "ws_s", "ws_z"),
                            scale_warm_start(wx, ws, wz, self._d, self._e,
                                             self._c)):
                dev[k] = self._put(v)
        if self.settings.verbose:
            info_print.print_banner(self.settings)
            info_print.print_configuration(
                self.settings, self.n, self.m, self._cones, self._has_P,
                self.settings.direct_solve_method)
            info_print.print_iteration_header()
        if math.isfinite(self.settings.time_limit):
            # host-clock origin of the in-loop MAX_TIME check
            # (settings.jl:73, info.jl:110-115)
            dev["t_start"] = time.time()
        trace = contextlib.nullcontext()
        if profile_dir is not None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            trace = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    profile_dir))
        t0 = time.perf_counter()
        with trace:
            out = {k: v[0].cpu().numpy()
                   for k, v in self._solve_fn(dev).items()}
        solve_time = time.perf_counter() - t0

        self.timers["solve"]["solve"] = solve_time
        status = SolverStatus(int(out["status"]))
        x, s, z = out["x"], out["s"], out["z"]
        # reverse chordal decomposition (solution.jl:30-34), then
        # reverse presolve (solution.jl:36-42)
        if self.chordal_info is not None:
            x, s, z = decomp_reverse(self.chordal_info, x, s, z,
                                     self.settings)
        if self.presolver is not None:
            s, z = presolve_mod.reverse_presolve(self.presolver, s, z)

        self.info = dict(out)
        self.info["solve_time"] = solve_time
        # linear-solver block of the reference's DefaultInfo
        # (types.jl:209-251)
        N = self.n + self.m
        method = resolve_kkt_method(self.settings, N)
        self.info["linear_solver"] = {
            "method": method,
            "factor_precision": resolve_factor_precision(self.settings),
            "kkt_dim": N,
            "nnzA": int(np.count_nonzero(self._As)),
            # the LDL^T kernels keep a triangle, LU the full square
            "nnzL": N * (N + 1) // 2 if method == "pallas" else N * N,
            "host_solve": False,
        }
        if method == "pallas":
            self.info["linear_solver"]["dd_npass"] = self._dd_npass
        self.solution = DefaultSolution(
            x=x,
            z=z,
            s=s,
            status=status,
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

    # ------------------------------------------------------------------
    def get_solution(self) -> Optional[DefaultSolution]:
        return self.solution

    def get_info(self) -> Optional[dict]:
        return self.info

    def profile_phases(self, reps: int = 3) -> dict:
        """Seconds per call of each IPM phase at this problem's shapes on
        the solver's device (scale cones, Hs assembly, KKT factor,
        refined KKT solve and its paired form, residual products, step
        length): the device-level counterpart of the reference's solve!
        timer sections (types.jl:362-372).  Results land in
        timers["device"] and print_timers() reports them."""
        from .profiling import phase_breakdown  # profiling imports Solver

        return phase_breakdown(self, reps=reps)

    def print_timers(self) -> None:
        """Hierarchical wall-clock report (print_timers(solver),
        solver.jl:534), with the phases of profile_phases() under
        "device" once it has run."""
        for section, entries in self.timers.items():
            total = sum(entries.values())
            print(f"{section:<16s} {total*1e3:10.3f} ms")
            for name, t in entries.items():
                print(f"  {name:<14s} {t*1e3:10.3f} ms")

    # -- parametric data updating (src/data_updating.jl) ----------------
    def _check_update_allowed(self):
        """Updates are forbidden once presolve has reduced rows or the
        PSD cones were decomposed (check_data_update_allowed,
        data_updating.jl:149-158)."""
        if self.presolver is not None:
            raise ValueError("Data updates not allowed if presolver is active.")
        if self.chordal_info is not None:
            raise ValueError(
                "Data updates not allowed if chordal decomposition is active.")

    def is_data_update_allowed(self) -> bool:
        try:
            self._check_update_allowed()
            return True
        except ValueError:
            return False

    @staticmethod
    def _as_update(values, target_shape, what):
        """Accept a full dense/sparse matrix, a flat row-major value
        vector, or an (indices, values) pair over flat row-major
        positions (the dense analog of the reference's nzval /
        SparseMatrixCSC / zip input forms, data_updating.jl:1-14)."""
        if isinstance(values, tuple) and len(values) == 2:
            return ("indexed", np.asarray(values[0], dtype=np.int64),
                    np.asarray(values[1], dtype=np.float64))
        if hasattr(values, "toarray"):
            values = values.toarray()
        arr = np.asarray(values, dtype=np.float64)
        if arr.ndim == 1 and len(target_shape) == 2:
            if arr.size == 0:
                return None
            if arr.size != target_shape[0] * target_shape[1]:
                raise ValueError(f"{what}: flat values must have length "
                                 f"{target_shape[0] * target_shape[1]}")
            arr = arr.reshape(target_shape)
        if arr.shape != target_shape:
            raise ValueError(f"{what}: expected shape {target_shape}")
        return ("full", arr, None)

    def update_P(self, P) -> None:
        """Overwrite P, re-applying the stored equilibration
        (update_P!, data_updating.jl:56-71): P_int = c * D P D."""
        if P is None:
            return
        self._check_update_allowed()
        upd = self._as_update(P, (self.n, self.n), "P")
        if upd is None:
            return
        kind, a1, a2 = upd
        d, c = self._d, self._c
        if kind == "full":
            Pd = np.triu(a1) + np.triu(a1, 1).T
            self._Ps = c * (d[:, None] * Pd * d[None, :])
        else:
            rows, cols = np.divmod(a1, self.n)
            vals = c * d[rows] * d[cols] * a2
            P_full = self._Ps.copy()
            P_full[rows, cols] = vals
            P_full[cols, rows] = vals
            self._Ps = P_full
        has_P = bool(np.any(self._Ps != 0.0))
        self._dev["P"] = self._put(self._Ps)
        if has_P != self._has_P:
            # the solve function is specialised on whether P is zero
            self._has_P = has_P
            self._refresh_solve_fn()

    def update_A(self, A) -> None:
        """A_int = E A D (update_A!, data_updating.jl:85-100)."""
        if A is None:
            return
        self._check_update_allowed()
        upd = self._as_update(A, (self.m, self.n), "A")
        if upd is None:
            return
        kind, a1, a2 = upd
        d, e = self._d, self._e
        if kind == "full":
            self._As = e[:, None] * a1 * d[None, :]
        else:
            rows, cols = np.divmod(a1, self.n)
            A_full = self._As.copy()
            A_full[rows, cols] = e[rows] * d[cols] * a2
            self._As = A_full
        self._dev["A"] = self._put(self._As)

    def update_q(self, q) -> None:
        """q_int = c * D q; refreshes the unscaled norm used by the
        relative termination criteria (update_q!,
        data_updating.jl:107-124)."""
        if q is None:
            return
        self._check_update_allowed()
        q = np.asarray(q, dtype=np.float64).ravel()
        if q.size == 0:
            return
        if q.shape[0] != self.n:
            raise ValueError("q: wrong length")
        self._qs = self._c * self._d * q
        self._dev["q"] = self._put(self._qs)
        self._dev["normq"] = self._put(float(np.abs(q).max()) if self.n
                                       else 0.0)

    def update_b(self, b) -> None:
        """b_int = E b (update_b!, data_updating.jl:133-147)."""
        if b is None:
            return
        self._check_update_allowed()
        b = np.asarray(b, dtype=np.float64).ravel()
        if b.size == 0:
            return
        if b.shape[0] != self.m:
            raise ValueError("b: wrong length")
        b = np.minimum(b, get_infinity())
        self._bs = self._e * b
        self._dev["b"] = self._put(self._bs)
        self._dev["normb"] = self._put(float(np.abs(b).max()) if self.m
                                       else 0.0)

    def update_data(self, P=None, q=None, A=None, b=None) -> None:
        """update_data! (data_updating.jl:26-39)."""
        self.update_P(P)
        self.update_q(q)
        self.update_A(A)
        self.update_b(b)

    # -- JSON I/O (src/json.jl) ------------------------------------------
    def save_to_file(self, path: str) -> None:
        """Write the (unscaled) internal problem data as JSON
        (save_to_file, json.jl:25-56), in the reference's schema."""
        dinv = 1.0 / self._d
        einv = 1.0 / self._e
        cinv = 1.0 / self._c
        P = cinv * (dinv[:, None] * self._Ps * dinv[None, :])
        q = cinv * dinv * self._qs
        A = einv[:, None] * self._As * dinv[None, :]
        b = einv * self._bs
        json_io.save_problem(self.settings, P, q, A, b, self._cones, path)

    @classmethod
    def load_from_file(cls, path: str, settings: Optional[Settings] = None,
                       device=None):
        """Create a Solver from a JSON problem file (load_from_file,
        json.jl:58-87), such as one the reference wrote."""
        P, q, A, b, cones, s = json_io.load_problem(path, settings)
        return cls(P, q, A, b, cones, settings=s, device=device)
