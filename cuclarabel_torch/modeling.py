"""Problem-builder modeling layer — the L8 interop surface.

A copy of `cuclarabel_tpu/modeling.py` (JAX-free; the port imports
nothing of the JAX package), whose `Model.solve` builds the port's
`Solver` or `SparseSolver` and passes the Model's `device` on (CUDA
unless the caller passes device="cpu").

The reference exposes an MOI `Optimizer` so JuMP/Convex.jl users never
assemble `(P, q, A, b, cones)` by hand (`src/MOI_wrapper/MOI_wrapper.jl:
91-122` Optimizer, `:362-495` copy_to/IndexMap/row ranges, `:497-686`
constraint-to-triplet assembly, `:688-770` objective incl. quadratic and
sense flip).  cvxpy is not available in this environment, so this module
is the Python-native equivalent: variables, affine/quadratic expressions
with operator overloading, conic constraints, and a `Model` that
assembles the solver-form data.

Semantics mirrored from the reference:
  * constraints are collected as  F x + g ∈ K  and posed to the solver
    as  A x + s = b, s ∈ K  with A = -F, b = g (the sign flip of
    `MOI_wrapper.jl:521-526`);
  * `maximize` negates the objective into the solver and restores the
    sign on reporting (`process_objective`, `MOI_wrapper.jl:688-770`);
  * quadratic objectives go in natively via P by default; with
    `use_quad_obj=False` they are bridged to an epigraph SecondOrderCone
    constraint instead (the `use_quad_obj` RawOptimizerAttribute,
    `MOI_wrapper.jl:236-257`);
  * termination/primal/dual status maps follow
    `ClarabeltoMOITerminationStatus` et al. (`MOI_wrapper.jl:48-85`).

Example::

    m = Model()
    x = m.add_variables(3)
    m.add_constraint(sum_entries(x) == 1.0)
    m.add_constraint(x >= 0.0)
    m.minimize(quad_form(x, Sigma) - mu @ x)
    sol = m.solve()
    x.value
"""

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .cones import api
from .settings import Settings
from .statuscodes import SolverStatus

__all__ = [
    "Model",
    "Variable",
    "AffineExpr",
    "QuadExpr",
    "NormExpr",
    "vstack",
    "sum_entries",
    "norm2",
    "quad_form",
    "sumsq",
    "svec_stack",
    "moi_termination_status",
    "moi_primal_status",
    "moi_dual_status",
]


def _as_const(v, k: int) -> np.ndarray:
    arr = np.asarray(v, dtype=np.float64)
    if arr.ndim == 0:
        return np.full(k, float(arr))
    arr = arr.ravel()
    if arr.shape[0] != k:
        raise ValueError(f"constant has length {arr.shape[0]}, expected {k}")
    return arr


class AffineExpr:
    """k-vector affine expression  F x + g  over a model's variables.

    Stored as COO triplets with *global* variable column indices, so
    expressions stay valid as more variables are added to the model."""

    __array_priority__ = 100  # beat ndarray in mixed operators

    def __init__(self, model, k, rows, cols, vals, const):
        self.model = model
        self.k = int(k)
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.vals = np.asarray(vals, dtype=np.float64)
        self.const = _as_const(const, k)

    # -- internals ----------------------------------------------------
    def _csr(self, ncols: int):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.vals, (self.rows, self.cols)), shape=(self.k, ncols)
        )

    @staticmethod
    def _coerce(model, other, k):
        """Turn scalars/arrays into constant AffineExpr of length k."""
        if isinstance(other, AffineExpr):
            return other
        return AffineExpr(model, k, [], [], [], _as_const(other, k))

    def _check_model(self, other):
        if isinstance(other, (AffineExpr, QuadExpr)) and other.model is not self.model:
            raise ValueError("expressions belong to different models")

    # -- arithmetic ---------------------------------------------------
    def __add__(self, other):
        self._check_model(other)
        if isinstance(other, QuadExpr):
            return other + self
        o = self._coerce(self.model, other, self.k)
        if o.k != self.k:
            raise ValueError("shape mismatch in +")
        return AffineExpr(
            self.model,
            self.k,
            np.concatenate([self.rows, o.rows]),
            np.concatenate([self.cols, o.cols]),
            np.concatenate([self.vals, o.vals]),
            self.const + o.const,
        )

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-1.0) * (
            other if isinstance(other, (AffineExpr, QuadExpr))
            else np.asarray(other, dtype=np.float64)
        )

    def __rsub__(self, other):
        return (-1.0) * self + other

    def __neg__(self):
        return (-1.0) * self

    def __mul__(self, c):
        if isinstance(c, AffineExpr):
            raise TypeError("product of two affine expressions is not affine; "
                            "use quad_form/sumsq for quadratics")
        c = np.asarray(c, dtype=np.float64)
        if c.ndim == 0:
            return AffineExpr(self.model, self.k, self.rows, self.cols,
                              self.vals * float(c), self.const * float(c))
        c = c.ravel()
        if c.shape[0] != self.k:
            raise ValueError("elementwise scale length mismatch")
        return AffineExpr(self.model, self.k, self.rows, self.cols,
                          self.vals * c[self.rows], self.const * c)

    __rmul__ = __mul__

    def __truediv__(self, c):
        return self * (1.0 / float(c))

    def __matmul__(self, other):
        # expr @ w  with w a constant vector -> scalar expression
        w = np.asarray(other, dtype=np.float64)
        if w.ndim != 1 or w.shape[0] != self.k:
            raise ValueError("expr @ w needs a length-k constant vector")
        return AffineExpr(
            self.model, 1,
            np.zeros_like(self.rows), self.cols, self.vals * w[self.rows],
            np.array([w @ self.const]),
        )

    def __rmatmul__(self, M):
        M = np.asarray(M, dtype=np.float64)
        if M.ndim == 1:
            return self.__matmul__(M)
        if M.ndim != 2 or M.shape[1] != self.k:
            raise ValueError(f"matrix of shape {M.shape} cannot multiply "
                             f"length-{self.k} expression")
        import scipy.sparse as sp

        E = self._csr(self.model.nvar)
        R = (sp.csr_matrix(M) @ E).tocoo()
        return AffineExpr(self.model, M.shape[0], R.row, R.col, R.data,
                          M @ self.const)

    def __getitem__(self, idx):
        sel = np.arange(self.k)[idx]
        sel = np.atleast_1d(sel)
        pos = -np.ones(self.k, dtype=np.int64)
        pos[sel] = np.arange(sel.shape[0])
        keep = pos[self.rows] >= 0
        return AffineExpr(self.model, sel.shape[0], pos[self.rows[keep]],
                          self.cols[keep], self.vals[keep], self.const[sel])

    # -- constraints --------------------------------------------------
    def __ge__(self, other):    # expr >= other  ->  expr - other ∈ NN
        d = self - other
        return Constraint(d, api.NonnegativeConeT(d.k))

    def __le__(self, other):    # expr <= other  ->  other - expr ∈ NN
        if isinstance(other, AffineExpr):
            d = other - self
        else:
            d = (-1.0) * self + other
        return Constraint(d, api.NonnegativeConeT(d.k))

    def __eq__(self, other):    # expr == other  ->  expr - other ∈ {0}
        d = self - other
        return Constraint(d, api.ZeroConeT(d.k))

    __hash__ = None

    # -- values -------------------------------------------------------
    @property
    def value(self) -> Optional[np.ndarray]:
        x = self.model._x
        if x is None:
            return None
        out = self.const.copy()
        np.add.at(out, self.rows, self.vals * x[self.cols])
        return out if self.k > 1 else float(out[0])


class Variable(AffineExpr):
    """A contiguous block of model variables (identity affine map)."""

    def __init__(self, model, offset: int, k: int, name: str = ""):
        idx = np.arange(k)
        super().__init__(model, k, idx, offset + idx, np.ones(k), np.zeros(k))
        self.offset = offset
        self.name = name


class NormExpr:
    """‖expr‖₂; usable only as `norm2(e) <= affine_scalar`."""

    def __init__(self, arg: AffineExpr):
        self.arg = arg

    def __le__(self, bound):
        # ‖v‖ ≤ t  ⟺  [t; v] ∈ SOC (cone_api.jl:27-29 ordering)
        t = AffineExpr._coerce(self.arg.model, bound, 1)
        if isinstance(bound, AffineExpr) and bound.k != 1:
            raise ValueError("SOC bound must be a scalar expression")
        stacked = vstack([t, self.arg])
        return Constraint(stacked, api.SecondOrderConeT(stacked.k))


class QuadExpr:
    """Scalar quadratic  x'Qx + (affine).  Q in COO over model vars."""

    def __init__(self, model, qrows, qcols, qvals, affine: AffineExpr):
        self.model = model
        self.qrows = np.asarray(qrows, dtype=np.int64)
        self.qcols = np.asarray(qcols, dtype=np.int64)
        self.qvals = np.asarray(qvals, dtype=np.float64)
        if affine.k != 1:
            raise ValueError("quadratic affine part must be scalar")
        self.affine = affine

    def __add__(self, other):
        if isinstance(other, QuadExpr):
            return QuadExpr(
                self.model,
                np.concatenate([self.qrows, other.qrows]),
                np.concatenate([self.qcols, other.qcols]),
                np.concatenate([self.qvals, other.qvals]),
                self.affine + other.affine,
            )
        if isinstance(other, AffineExpr) and other.k != 1:
            raise ValueError("can only add scalar expressions to a quadratic")
        return QuadExpr(self.model, self.qrows, self.qcols, self.qvals,
                        self.affine + other)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-1.0) * other

    def __rsub__(self, other):
        return (-1.0) * self + other

    def __neg__(self):
        return (-1.0) * self

    def __mul__(self, c):
        c = float(c)
        return QuadExpr(self.model, self.qrows, self.qcols, self.qvals * c,
                        self.affine * c)

    __rmul__ = __mul__

    @property
    def value(self):
        x = self.model._x
        if x is None:
            return None
        quad = float(np.sum(self.qvals * x[self.qrows] * x[self.qcols]))
        aff = self.affine.value
        return quad + float(aff)


class Constraint:
    """F x + g ∈ K, recorded by Model.add_constraint."""

    def __init__(self, expr: AffineExpr, cone: api.SupportedCone):
        if api.nvars(cone) != expr.k:
            raise ValueError(
                f"cone dimension {api.nvars(cone)} != expression length {expr.k}"
            )
        self.expr = expr
        self.cone = cone
        self._range: Optional[Tuple[int, int]] = None  # set at assembly

    @property
    def dual(self) -> Optional[np.ndarray]:
        z = self.expr.model._z
        if z is None or self._range is None:
            return None
        lo, hi = self._range
        return z[lo:hi]

    @property
    def slack(self) -> Optional[np.ndarray]:
        s = self.expr.model._s
        if s is None or self._range is None:
            return None
        lo, hi = self._range
        return s[lo:hi]


# ---------------------------------------------------------------------
# free functions
# ---------------------------------------------------------------------

def vstack(exprs: Sequence[Union[AffineExpr, float, np.ndarray]]) -> AffineExpr:
    model = next(e.model for e in exprs if isinstance(e, AffineExpr))
    parts = []
    for e in exprs:
        if isinstance(e, AffineExpr):
            parts.append(e)
        else:
            arr = np.atleast_1d(np.asarray(e, dtype=np.float64))
            parts.append(AffineExpr(model, arr.shape[0], [], [], [], arr))
    k = sum(p.k for p in parts)
    rows, cols, vals, consts = [], [], [], []
    off = 0
    for p in parts:
        if p.model is not model:
            raise ValueError("expressions belong to different models")
        rows.append(p.rows + off)
        cols.append(p.cols)
        vals.append(p.vals)
        consts.append(p.const)
        off += p.k
    return AffineExpr(model, k, np.concatenate(rows), np.concatenate(cols),
                      np.concatenate(vals), np.concatenate(consts))


def sum_entries(expr: AffineExpr) -> AffineExpr:
    return expr @ np.ones(expr.k)


def norm2(expr: AffineExpr) -> NormExpr:
    return NormExpr(expr)


def quad_form(expr: AffineExpr, M) -> QuadExpr:
    """expr' M expr (M symmetric PSD constant).  For a plain Variable
    this lands directly in P; for a general affine expr the quadratic is
    expanded through the affine map."""
    M = np.asarray(M, dtype=np.float64)
    if M.shape != (expr.k, expr.k):
        raise ValueError("quad_form matrix shape mismatch")
    M = 0.5 * (M + M.T)
    import scipy.sparse as sp

    E = expr._csr(expr.model.nvar)
    Q = (E.T @ sp.csr_matrix(M) @ E).tocoo()  # x' F'MF x
    lin = (2.0 * (M @ expr.const)) @ E  # 2 g'M F x
    lin_expr = AffineExpr(expr.model, 1, np.zeros(len(lin.nonzero()[0])),
                          lin.nonzero()[0], lin[lin.nonzero()[0]],
                          np.array([expr.const @ (M @ expr.const)]))
    return QuadExpr(expr.model, Q.row, Q.col, Q.data, lin_expr)


def sumsq(expr: AffineExpr) -> QuadExpr:
    """‖expr‖² as a quadratic objective term."""
    return quad_form(expr, np.eye(expr.k))


def svec_stack(M) -> AffineExpr:
    """Stack a (d, d) symmetric matrix of scalar expressions/constants
    into the svec (scaled upper-triangle, column-major) layout the
    PSDTriangleConeT expects: off-diagonal entries scaled by sqrt(2)
    (svec convention of coneops_psdtrianglecone.jl:469-497)."""
    d = len(M)
    rt2 = float(np.sqrt(2.0))
    parts = []
    for j in range(d):
        for i in range(j + 1):
            e = M[i][j]
            scale = 1.0 if i == j else rt2
            if isinstance(e, AffineExpr):
                if e.k != 1:
                    raise ValueError("matrix entries must be scalars")
                parts.append(e * scale)
            else:
                parts.append(float(e) * scale)
    return vstack(parts)


# ---------------------------------------------------------------------
# status maps (MOI_wrapper.jl:48-85)
# ---------------------------------------------------------------------

_TERMINATION = {
    SolverStatus.SOLVED: "OPTIMAL",
    SolverStatus.MAX_ITERATIONS: "ITERATION_LIMIT",
    SolverStatus.MAX_TIME: "TIME_LIMIT",
    SolverStatus.PRIMAL_INFEASIBLE: "INFEASIBLE",
    SolverStatus.DUAL_INFEASIBLE: "DUAL_INFEASIBLE",
    SolverStatus.ALMOST_SOLVED: "ALMOST_OPTIMAL",
    SolverStatus.ALMOST_PRIMAL_INFEASIBLE: "ALMOST_INFEASIBLE",
    SolverStatus.ALMOST_DUAL_INFEASIBLE: "ALMOST_DUAL_INFEASIBLE",
    SolverStatus.NUMERICAL_ERROR: "NUMERICAL_ERROR",
    SolverStatus.INSUFFICIENT_PROGRESS: "SLOW_PROGRESS",
    SolverStatus.UNSOLVED: "OPTIMIZE_NOT_CALLED",
}

_PRIMAL = {
    SolverStatus.SOLVED: "FEASIBLE_POINT",
    SolverStatus.PRIMAL_INFEASIBLE: "INFEASIBLE_POINT",
    SolverStatus.DUAL_INFEASIBLE: "INFEASIBILITY_CERTIFICATE",
    SolverStatus.ALMOST_SOLVED: "NEARLY_FEASIBLE_POINT",
    SolverStatus.ALMOST_PRIMAL_INFEASIBLE: "INFEASIBLE_POINT",
    SolverStatus.ALMOST_DUAL_INFEASIBLE: "NEARLY_INFEASIBILITY_CERTIFICATE",
}

_DUAL = {
    SolverStatus.SOLVED: "FEASIBLE_POINT",
    SolverStatus.PRIMAL_INFEASIBLE: "INFEASIBILITY_CERTIFICATE",
    SolverStatus.DUAL_INFEASIBLE: "INFEASIBLE_POINT",
    SolverStatus.ALMOST_SOLVED: "NEARLY_FEASIBLE_POINT",
    SolverStatus.ALMOST_PRIMAL_INFEASIBLE: "NEARLY_INFEASIBILITY_CERTIFICATE",
    SolverStatus.ALMOST_DUAL_INFEASIBLE: "INFEASIBLE_POINT",
}


def moi_termination_status(status: SolverStatus) -> str:
    return _TERMINATION.get(status, "OTHER_ERROR")


def moi_primal_status(status: SolverStatus) -> str:
    return _PRIMAL.get(status, "OTHER_RESULT_STATUS")


def moi_dual_status(status: SolverStatus) -> str:
    return _DUAL.get(status, "OTHER_RESULT_STATUS")


# ---------------------------------------------------------------------
# the Model
# ---------------------------------------------------------------------

class Model:
    """Builder collecting variables/constraints/objective, assembling the
    solver-form `(P, q, A, b, cones)` on `solve()` (the copy_to analog,
    `MOI_wrapper.jl:362-495`).  `device` goes to the solver it builds."""

    def __init__(self, settings: Optional[Settings] = None, device=None,
                 **kwargs):
        self.device = device
        self.settings = (settings or Settings())
        if kwargs:
            self.settings = self.settings.replace(**kwargs)
        self.nvar = 0
        self.constraints: List[Constraint] = []
        self._objective: Union[AffineExpr, QuadExpr, None] = None
        self._sense = 1.0  # +1 minimize, -1 maximize
        self._x = None
        self._z = None
        self._s = None
        self.solution = None
        self.solver = None

    # -- build --------------------------------------------------------
    def add_variables(self, k: int, name: str = "") -> Variable:
        v = Variable(self, self.nvar, int(k), name)
        self.nvar += int(k)
        return v

    def add_variable(self, name: str = "") -> Variable:
        return self.add_variables(1, name)

    def add_constraint(self, con, cone: Optional[api.SupportedCone] = None):
        """Either a Constraint from an overloaded comparison, or a raw
        (expr, cone) membership `F x + g ∈ K` (the VectorAffineFunction-
        in-Set form of `MOI_wrapper.jl:497-686`)."""
        if isinstance(con, AffineExpr):
            if cone is None:
                raise ValueError("raw expression needs an explicit cone")
            con = Constraint(con, cone)
        elif not isinstance(con, Constraint):
            raise TypeError(f"cannot add {type(con)} as a constraint")
        self.constraints.append(con)
        return con

    def add_psd_constraint(self, M):
        """M (d, d) nested list/array of scalar expressions: constrain
        the symmetric matrix to be PSD (svec into PSDTriangleConeT; the
        MOI PositiveSemidefiniteConeTriangle analog)."""
        d = len(M)
        expr = svec_stack(M)
        return self.add_constraint(expr, api.PSDTriangleConeT(d))

    def minimize(self, expr):
        self._objective = expr
        self._sense = 1.0

    def maximize(self, expr):
        self._objective = expr
        self._sense = -1.0

    # -- assembly + solve --------------------------------------------
    def _assemble(self, use_quad_obj: bool, sparse: bool = False):
        import scipy.sparse as sp

        obj = self._objective
        if obj is None:
            obj = AffineExpr(self, 1, [], [], [], np.zeros(1))
        if isinstance(obj, Variable):
            obj = sum_entries(obj) if obj.k > 1 else obj
        if isinstance(obj, AffineExpr) and obj.k != 1:
            raise ValueError("objective must be a scalar expression")

        constraints = list(self.constraints)
        extra_nvar = 0

        if isinstance(obj, QuadExpr):
            # x'Qx + affine ; solver wants 0.5 x'Px so P = 2*sym(Q)
            Q = sp.coo_matrix(
                (obj.qvals * self._sense, (obj.qrows, obj.qcols)),
                shape=(self.nvar, self.nvar),
            ).toarray()
            Q = Q + Q.T  # symmetrize *and* fold the factor 2
            aff = obj.affine
            if not use_quad_obj and np.any(Q):
                # epigraph bridge (use_quad_obj=false semantics):
                # 0.5 x'Qx ≤ t  ⟺  [t+0.5; t-0.5; Cx] ∈ SOC, C'C = Q
                w, V = np.linalg.eigh(Q)
                w = np.clip(w, 0.0, None)
                C = (V * np.sqrt(w)) @ V.T
                n0 = self.nvar  # vars the quadratic ranges over
                t = self.add_variables(1, name="_quad_epi")
                extra_nvar += 1
                idx = np.arange(n0)
                x_all = AffineExpr(self, n0, idx, idx, np.ones(n0),
                                   np.zeros(n0))
                stacked = vstack([t + 0.5, t - 0.5, C @ x_all])
                constraints.append(
                    Constraint(stacked, api.SecondOrderConeT(stacked.k))
                )
                lin = self._sense * aff + t
                P = None
                q_expr = lin
            else:
                P = Q
                q_expr = self._sense * aff
        else:
            P = None
            q_expr = self._sense * obj

        n = self.nvar
        q = np.zeros(n)
        np.add.at(q, q_expr.cols, q_expr.vals)
        obj_const = float(q_expr.const[0])

        rows_all, cols_all, vals_all, b_parts, cones = [], [], [], [], []
        off = 0
        for c in constraints:
            e = c.expr
            rows_all.append(e.rows + off)
            cols_all.append(e.cols)
            vals_all.append(e.vals)
            b_parts.append(e.const)
            cones.append(c.cone)
            c._range = (off, off + e.k)
            off += e.k
        m = off
        if m == 0:
            raise ValueError("model has no constraints")
        # Ax + b ∈ K  ->  A_solver = -F, b_solver = g
        # (MOI_wrapper.jl:521-526)
        A = sp.coo_matrix(
            (
                -np.concatenate(vals_all) if vals_all else [],
                (
                    np.concatenate(rows_all) if rows_all else [],
                    np.concatenate(cols_all) if cols_all else [],
                ),
            ),
            shape=(m, n),
        )
        b = np.concatenate(b_parts) if b_parts else np.zeros(0)

        if P is not None and P.shape[0] < n:
            # quad P built before epigraph vars were added
            Pn = np.zeros((n, n))
            Pn[: P.shape[0], : P.shape[0]] = P
            P = Pn
        if sparse:
            return (
                sp.csc_matrix(P) if P is not None and np.any(P) else None,
                q, A.tocsc(), b, cones, obj_const,
            )
        A = A.toarray()
        if P is None:
            P = np.zeros((n, n))
        return P, q, A, b, cones, obj_const

    def solve(self, use_quad_obj: bool = True, backend: str = "dense",
              **override):
        """Assemble and solve.  backend='dense' uses Solver; 'sparse'
        keeps the assembled triplets sparse and uses SparseSolver (the
        device multifrontal KKT path) — pick it for large models."""
        settings = self.settings.replace(**override) if override else self.settings
        if backend == "sparse":
            from .sparse_solver import SparseSolver

            P, q, A, b, cones, obj_const = self._assemble(
                use_quad_obj, sparse=True
            )
            self.solver = SparseSolver(P, q, A, b, cones,
                                       settings=settings,
                                       device=self.device)
        elif backend == "dense":
            from .solver import Solver

            P, q, A, b, cones, obj_const = self._assemble(use_quad_obj)
            self.solver = Solver(P, q, A, b, cones, settings=settings,
                                 device=self.device)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        sol = self.solver.solve()
        self._x = np.asarray(sol.x)
        self._z = np.asarray(sol.z)
        self._s = np.asarray(sol.s)
        # sense flip + constant restoration on the reported objective
        sol.obj_val = self._sense * (sol.obj_val + obj_const)
        sol.obj_val_dual = self._sense * (sol.obj_val_dual + obj_const)
        self.solution = sol
        return sol

    # -- results ------------------------------------------------------
    @property
    def status(self) -> Optional[SolverStatus]:
        return None if self.solution is None else self.solution.status

    @property
    def termination_status(self) -> str:
        if self.solution is None:
            return "OPTIMIZE_NOT_CALLED"
        return moi_termination_status(self.solution.status)

    @property
    def primal_status(self) -> str:
        if self.solution is None:
            return "NO_SOLUTION"
        return moi_primal_status(self.solution.status)

    @property
    def dual_status(self) -> str:
        if self.solution is None:
            return "NO_SOLUTION"
        return moi_dual_status(self.solution.status)

    @property
    def objective_value(self) -> Optional[float]:
        return None if self.solution is None else self.solution.obj_val


def _promote_to_current_nvar(model: Model, obj: QuadExpr) -> AffineExpr:
    """Identity affine expr over the quadratic's variable support, used
    by the epigraph bridge to form Cx after new vars were added."""
    idx = np.arange(model.nvar)
    return AffineExpr(model, model.nvar, idx, idx, np.ones(model.nvar),
                      np.zeros(model.nvar))
