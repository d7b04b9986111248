"""QPS (quadratic MPS) reader/writer — the Maros-Meszaros corpus
format.

A copy of `cuclarabel_tpu/qps.py` (numpy and scipy only).

The reference consumes problems through Julia structures and has no
QPS reader; this module exists so any member of the public QP corpora
(Maros-Meszaros, CUTEst exports) can be loaded and routed through the
solvers (`benchmarks/suite.py --maros <dir>` for the JAX package).
Parsing follows the classical MPS layout with the QUADOBJ/QMATRIX
quadratic extension:

  NAME, OBJSENSE, ROWS (N/E/L/G), COLUMNS (with INTORG/INTEND
  markers rejected — this is a continuous conic solver), RHS, RANGES,
  BOUNDS (UP/LO/FX/FR/MI/PL), QUADOBJ (lower triangle of Q) or
  QMATRIX (full Q), ENDATA.

Objective convention (Maros-Meszaros): minimize c0 + c'x + 1/2 x'Qx.
The RHS entry on the objective row supplies -c0.

`to_clarabel` converts to the solver's conic form
    min 1/2 x'Px + q'x   s.t.  Ax + s = b,  s in Zero x Nonneg
with E rows (and FX bounds) in the zero cone and L/G/RANGES rows plus
finite variable bounds as nonnegative-cone rows (the same reduction the
reference's MOI bridge layer performs for *-in-Interval constraints,
src/MOI_wrapper/MOI_wrapper.jl:497+).
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class QPSProblem:
    name: str
    c0: float
    c: np.ndarray                  # (n,)
    Q: "object"                    # scipy.sparse (n, n), SYMMETRIC full
    A: "object"                    # scipy.sparse (m, n) row constraints
    rl: np.ndarray                 # (m,) row lower bounds (-inf allowed)
    ru: np.ndarray                 # (m,) row upper bounds (+inf allowed)
    lb: np.ndarray                 # (n,) variable lower bounds
    ub: np.ndarray                 # (n,) variable upper bounds
    col_names: List[str] = dataclasses.field(default_factory=list)
    row_names: List[str] = dataclasses.field(default_factory=list)
    maximize: bool = False

    @property
    def n(self):
        return self.c.shape[0]


def load_qps(path: str) -> QPSProblem:
    with open(path) as f:
        return parse_qps(f.read(), name_hint=path)


def parse_qps(text: str, name_hint: str = "") -> QPSProblem:
    import scipy.sparse as sp

    name = name_hint
    section = None
    obj_row: Optional[str] = None
    row_type: Dict[str, str] = {}
    row_order: List[str] = []
    col_index: Dict[str, int] = {}
    col_names: List[str] = []
    c_entries: Dict[int, float] = {}
    a_entries: List[Tuple[str, int, float]] = []
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    lb: Dict[int, float] = {}
    ub: Dict[int, float] = {}
    lb_seen: set = set()
    q_entries: List[Tuple[int, int, float]] = []
    q_is_full = False
    c0 = 0.0
    maximize = False
    in_integer = False
    pending_objsense = False

    def colid(cn: str) -> int:
        if cn not in col_index:
            col_index[cn] = len(col_names)
            col_names.append(cn)
        return col_index[cn]

    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith(("*", "$")):
            continue
        is_header = raw[0] not in " \t"
        toks = raw.split()
        if is_header:
            head = toks[0].upper()
            if head == "NAME":
                name = toks[1] if len(toks) > 1 else name
                section = "NAME"
            elif head == "OBJSENSE":
                section = "OBJSENSE"
                pending_objsense = True
                if len(toks) > 1:
                    maximize = toks[1].upper().startswith("MAX")
                    pending_objsense = False
            elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                          "QUADOBJ", "QMATRIX", "ENDATA", "OBJSENSE"):
                section = head
                if head == "QMATRIX":
                    q_is_full = True
                if head == "ENDATA":
                    break
            else:
                raise ValueError(f"unknown QPS section {head!r}")
            continue

        if section == "OBJSENSE" and pending_objsense:
            maximize = toks[0].upper().startswith("MAX")
            pending_objsense = False
        elif section == "ROWS":
            t = toks[0].upper()
            rn = toks[1]
            if t == "N":
                if obj_row is None:
                    obj_row = rn
                # later N rows are free rows: recorded but unconstrained
                else:
                    row_type[rn] = "FREE"
                    row_order.append(rn)
            elif t in ("E", "L", "G"):
                row_type[rn] = t
                row_order.append(rn)
            else:
                raise ValueError(f"unknown row type {t!r}")
        elif section == "COLUMNS":
            if len(toks) >= 3 and toks[1].upper() == "'MARKER'":
                kind = toks[2].strip("'\"").upper()
                if kind == "INTORG":
                    in_integer = True
                elif kind == "INTEND":
                    in_integer = False
                continue
            if in_integer:
                raise ValueError(
                    "integer variables (INTORG) are not supported by a "
                    "continuous conic solver"
                )
            cn = toks[0]
            j = colid(cn)
            for rn, val in zip(toks[1::2], toks[2::2]):
                v = float(val)
                if rn == obj_row:
                    c_entries[j] = c_entries.get(j, 0.0) + v
                elif rn in row_type:
                    if row_type[rn] != "FREE":
                        a_entries.append((rn, j, v))
                else:
                    raise ValueError(f"COLUMNS references unknown row {rn!r}")
        elif section == "RHS":
            # odd token count => leading RHS set name (any), then
            # (row, value) pairs; even => the common nameless dialect
            # that omits the set name entirely
            start = 1 if len(toks) % 2 else 0
            for rn, val in zip(toks[start::2], toks[start + 1 :: 2]):
                v = float(val)
                if rn == obj_row:
                    c0 = -v
                else:
                    rhs[rn] = v
        elif section == "RANGES":
            start = 1 if len(toks) % 2 else 0
            for rn, val in zip(toks[start::2], toks[start + 1 :: 2]):
                ranges[rn] = float(val)
        elif section == "BOUNDS":
            bt = toks[0].upper()
            cn = toks[2]
            j = colid(cn)
            v = float(toks[3]) if len(toks) > 3 else 0.0
            if bt == "UP":
                ub[j] = v
                # classical MPS quirk: a negative upper bound with no
                # explicit lower bound implies the lower bound is -inf
                if v < 0.0 and j not in lb_seen:
                    lb[j] = -np.inf
            elif bt == "LO":
                lb[j] = v
                lb_seen.add(j)
            elif bt == "FX":
                lb[j] = v
                ub[j] = v
                lb_seen.add(j)
            elif bt == "FR":
                lb[j] = -np.inf
                ub[j] = np.inf
                lb_seen.add(j)
            elif bt == "MI":
                lb[j] = -np.inf
                lb_seen.add(j)
            elif bt == "PL":
                ub[j] = np.inf
            elif bt in ("BV", "LI", "UI", "SC"):
                raise ValueError(f"bound type {bt} (integer/semicont) "
                                 "not supported")
            else:
                raise ValueError(f"unknown bound type {bt!r}")
        elif section in ("QUADOBJ", "QMATRIX"):
            i = colid(toks[0])
            j = colid(toks[1])
            q_entries.append((i, j, float(toks[2])))
        elif section in ("NAME", None):
            pass
        else:
            raise ValueError(f"data line outside a known section: {raw!r}")

    n = len(col_names)
    m = len(row_order)
    ridx = {rn: i for i, rn in enumerate(row_order)}

    c = np.zeros(n)
    for j, v in c_entries.items():
        c[j] = v

    rows = np.array([ridx[rn] for rn, _, _ in a_entries], dtype=np.int64)
    cols = np.array([j for _, j, _ in a_entries], dtype=np.int64)
    vals = np.array([v for _, _, v in a_entries])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()

    rl = np.full(m, -np.inf)
    ru = np.full(m, np.inf)
    for rn in row_order:
        i = ridx[rn]
        t = row_type[rn]
        b = rhs.get(rn, 0.0)
        if t == "E":
            rl[i] = ru[i] = b
        elif t == "L":
            ru[i] = b
        elif t == "G":
            rl[i] = b
        # FREE: stays (-inf, inf)
        if rn in ranges:
            r = ranges[rn]
            if t == "E":
                if r >= 0:
                    ru[i] = b + r
                else:
                    rl[i] = b + r
            elif t == "L":
                rl[i] = b - abs(r)
            elif t == "G":
                ru[i] = b + abs(r)

    # MPS default variable bounds: [0, +inf)
    lbv = np.zeros(n)
    ubv = np.full(n, np.inf)
    for j, v in lb.items():
        lbv[j] = v
    for j, v in ub.items():
        ubv[j] = v

    if q_entries:
        qi = np.array([i for i, _, _ in q_entries], dtype=np.int64)
        qj = np.array([j for _, j, _ in q_entries], dtype=np.int64)
        qv = np.array([v for _, _, v in q_entries])
        Q = sp.coo_matrix((qv, (qi, qj)), shape=(n, n)).tocsc()
        if not q_is_full:
            # QUADOBJ supplies one triangle; symmetrize
            D = sp.diags(Q.diagonal())
            Q = Q + Q.T - D
    else:
        Q = sp.csc_matrix((n, n))

    return QPSProblem(
        name=name, c0=c0, c=c, Q=Q, A=A, rl=rl, ru=ru, lb=lbv, ub=ubv,
        col_names=col_names, row_names=row_order, maximize=maximize,
    )


def to_clarabel(p: QPSProblem):
    """QPSProblem -> (P, q, A, b, cones, c0) in the solver's conic form.

    minimize 1/2 x'Px + q'x subject to Ax + s = b with s in
    ZeroCone(meq) x NonnegativeCone(mineq); objective value of the
    original QPS problem = solver objective + c0 (sign-flipped for
    OBJSENSE MAX).
    """
    import scipy.sparse as sp

    from .cones.api import NonnegativeConeT, ZeroConeT

    n = p.n
    sgn = -1.0 if p.maximize else 1.0
    P = sp.triu((sgn * p.Q).tocoo()).tocsc()
    q = sgn * p.c

    eq_rows = []
    eq_b = []
    in_rows = []
    in_b = []
    I = sp.eye(n, format="csr")
    Acsr = p.A.tocsr()

    for i in range(p.A.shape[0]):
        rlo, rup = p.rl[i], p.ru[i]
        if rlo == rup and np.isfinite(rlo):
            eq_rows.append(Acsr[i])
            eq_b.append(rlo)
        else:
            if np.isfinite(rup):
                in_rows.append(Acsr[i])
                in_b.append(rup)
            if np.isfinite(rlo):
                in_rows.append(-Acsr[i])
                in_b.append(-rlo)

    for j in range(n):
        vlo, vup = p.lb[j], p.ub[j]
        if vlo == vup and np.isfinite(vlo):
            eq_rows.append(I[j])
            eq_b.append(vlo)
        else:
            if np.isfinite(vup):
                in_rows.append(I[j])
                in_b.append(vup)
            if np.isfinite(vlo):
                in_rows.append(-I[j])
                in_b.append(-vlo)

    blocks = eq_rows + in_rows
    A = (sp.vstack(blocks).tocsc() if blocks
         else sp.csc_matrix((0, n)))
    b = np.array(eq_b + in_b, dtype=np.float64)
    cones = []
    if eq_rows:
        cones.append(ZeroConeT(len(eq_rows)))
    if in_rows:
        cones.append(NonnegativeConeT(len(in_rows)))
    return P, q, A, b, cones, (sgn, p.c0)


def qps_objective(sgn_c0, solver_obj: float) -> float:
    """Map the solver's objective back to the QPS problem's (adds the
    constant, restores OBJSENSE MAX sign)."""
    sgn, c0 = sgn_c0
    return sgn * solver_obj + c0


def write_qps(p: QPSProblem, path: str) -> None:
    """Minimal QPS writer (round-trip fidelity for testing and for
    exporting transcribed corpus members)."""
    L = [f"NAME          {p.name}"]
    if p.maximize:
        L.append("OBJSENSE")
        L.append("    MAX")
    L.append("ROWS")
    L.append(" N  OBJ")
    for i, rn in enumerate(p.row_names):
        rlo, rup = p.rl[i], p.ru[i]
        if rlo == rup and np.isfinite(rlo):
            L.append(f" E  {rn}")
        elif np.isfinite(rup) and np.isfinite(rlo):
            L.append(f" L  {rn}")   # + RANGES below
        elif np.isfinite(rup):
            L.append(f" L  {rn}")
        elif np.isfinite(rlo):
            L.append(f" G  {rn}")
        else:
            L.append(f" N  {rn}")
    L.append("COLUMNS")
    Acsc = p.A.tocsc()
    for j, cn in enumerate(p.col_names):
        if p.c[j] != 0.0:
            L.append(f"    {cn}  OBJ  {float(p.c[j])!r}")
        col = Acsc.getcol(j).tocoo()
        for i, v in zip(col.row, col.data):
            L.append(f"    {cn}  {p.row_names[i]}  {float(v)!r}")
    L.append("RHS")
    if p.c0 != 0.0:
        L.append(f"    RHS  OBJ  {float(-p.c0)!r}")
    for i, rn in enumerate(p.row_names):
        rlo, rup = p.rl[i], p.ru[i]
        bval = rlo if (rlo == rup or not np.isfinite(rup)) else rup
        if np.isfinite(bval) and bval != 0.0:
            L.append(f"    RHS  {rn}  {float(bval)!r}")
    rng = [
        (rn, p.ru[i] - p.rl[i])
        for i, rn in enumerate(p.row_names)
        if np.isfinite(p.rl[i]) and np.isfinite(p.ru[i]) and p.rl[i] != p.ru[i]
    ]
    if rng:
        L.append("RANGES")
        for rn, r in rng:
            L.append(f"    RNG  {rn}  {float(r)!r}")
    L.append("BOUNDS")
    for j, cn in enumerate(p.col_names):
        vlo, vup = p.lb[j], p.ub[j]
        if vlo == vup and np.isfinite(vlo):
            L.append(f" FX BND  {cn}  {float(vlo)!r}")
            continue
        if not np.isfinite(vlo) and not np.isfinite(vup):
            L.append(f" FR BND  {cn}")
            continue
        if vlo != 0.0:
            if np.isfinite(vlo):
                L.append(f" LO BND  {cn}  {float(vlo)!r}")
            else:
                L.append(f" MI BND  {cn}")
        if np.isfinite(vup):
            L.append(f" UP BND  {cn}  {float(vup)!r}")
    Qlow = None
    import scipy.sparse as sp

    Qlow = sp.tril(p.Q.tocoo())
    if Qlow.nnz:
        L.append("QUADOBJ")
        for i, j, v in zip(Qlow.row, Qlow.col, Qlow.data):
            L.append(f"    {p.col_names[i]}  {p.col_names[j]}  {float(v)!r}")
    L.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")
