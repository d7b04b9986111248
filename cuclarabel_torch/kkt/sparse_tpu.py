"""Sparse KKT backend on the device: assembly maps + multifrontal LDL^T.

The counterpart of `cuclarabel_tpu/kkt/sparse_tpu.py`, under the same
module and function names so that a reader finds it; here it is the
CUDA device's sparse KKT.  The sparse analog of kkt/dense.py, mirroring
the reference's sparse pipeline: two-pass CSC assembly with structural
diagonal (`directldl_kkt_assembly.jl:15-175`), O(nnz) value updates via
precomputed index maps (`directldl_datamaps.jl:170-213`), QDLDL-style
factorization with static + dynamic signed regularization
(`kktsolver_directldl.jl:247-310`, `directldl_qdldl.jl:18-25`) and
iterative refinement against the unregularized operator
(`kktsolver_directldl.jl:389-449`) — with the numeric factorization
running on the device as the level-scheduled batched multifrontal of
kkt/sparse_device.py.

Cone coverage: Zero/Nonnegative (diagonal Hs), SOC — dense blocks up
to dim 4, the rank-2 sparse expansion above (SOC_NO_EXPANSION_MAX_SIZE,
`cone_types.jl:65-119`; u/v columns + (-1,+1) extension diagonal per
`directldl_datamaps.jl:8-79`) — exp/pow 3x3 blocks, PSD svec blocks and
GenPow (rank-3 expansion).

Every value carries a leading batch dimension B (one pattern, B sets of
values).  Sums over repeated targets (the K assembly, the K x of the
refinement and the loop's P x, A x and A' z) run in a fixed order
(`kkt/scatter.py`), so a repeated solve is bitwise equal on the card.
The host symbolic analysis and the device's index maps are memoised on
the `SparseProblem`, so they are built and uploaded once per problem.
"""

import dataclasses
import os

import numpy as np
import torch

from ..device import resolve_device
from .scatter import Scatter, SegmentSum
from .sparse_device import (
    DeviceMaps,
    _split_wide_supernodes,
    _value_permutation,
    build_numeric_plan,
    factor as mf_factor,
    solve as mf_solve,
)
from .sparse_symbolic import analyze, nested_dissection


@dataclasses.dataclass
class SparseProblem:
    """Static sparsity metadata of one problem (host numpy only).

    P: upper-triangle COO of the objective (rows <= cols);
    A: COO of the constraint matrix."""

    n: int
    m: int
    P_rows: np.ndarray
    P_cols: np.ndarray
    A_rows: np.ndarray
    A_cols: np.ndarray
    # memo for make_sparse_tpu_kkt (the symbolic analysis is the
    # expensive host step, and the index maps go to the device once)
    _kkt_memo: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @classmethod
    def from_scipy(cls, P, A):
        import scipy.sparse as sp

        n = A.shape[1]
        m = A.shape[0]
        if P is not None:
            Pu = sp.triu(sp.csc_matrix(P)).tocoo()
            pr, pc = Pu.row.astype(np.int64), Pu.col.astype(np.int64)
        else:
            pr = pc = np.zeros(0, dtype=np.int64)
        Ac = sp.coo_matrix(A)
        return cls(n=n, m=m, P_rows=pr, P_cols=pc,
                   A_rows=Ac.row.astype(np.int64),
                   A_cols=Ac.col.astype(np.int64))

    def P_vals(self, P):
        import scipy.sparse as sp

        if P is None:
            return np.zeros(0)
        Pu = sp.triu(sp.csc_matrix(P)).tocoo()
        return np.asarray(Pu.data, dtype=np.float64)

    def A_vals(self, A):
        import scipy.sparse as sp

        return np.asarray(sp.coo_matrix(A).data, dtype=np.float64)


def _host_analysis(n, m, layout, sp_prob, max_width):
    """The reference's host part of make_sparse_tpu_kkt (:115-298): the
    K pattern and its value maps, the nested-dissection symbolic plan
    and the numeric plan.  Returns a dict of numpy arrays and plans."""
    from ..cones import ops as cone_ops

    hs_plan = cone_ops.sparse_hs_plan(layout)
    nx = len(hs_plan["socx_rows"])       # expanded SOC count
    ngx = len(hs_plan["gpx_cone"])       # GenPow count (always expanded)
    N = n + m
    Next = N + 2 * nx + 3 * ngx

    # ---- K upper pattern + datamaps (host) --------------------------
    # entries: P upper at (i, j); A at (c, n + r); structural diagonal
    coords = {}

    def slot(i, j):
        key = (int(i), int(j))
        if key not in coords:
            coords[key] = len(coords)
        return coords[key]

    p_map = np.asarray(
        [slot(i, j) for i, j in zip(sp_prob.P_rows, sp_prob.P_cols)],
        dtype=np.int64,
    )
    a_map = np.asarray(
        [slot(c, n + r) for r, c in zip(sp_prob.A_rows, sp_prob.A_cols)],
        dtype=np.int64,
    )
    # Hs dense-block entries (small SOC + exp/pow 3x3 + PSD)
    blk_map = np.asarray(
        [slot(n + i, n + j)
         for i, j in zip(hs_plan["blk_rows"], hs_plan["blk_cols"])],
        dtype=np.int64,
    )
    # SOC rank-2 expansion columns: v first, then u (datamaps order)
    xv_map, xu_map = [], []
    for t, rows in enumerate(hs_plan["socx_rows"]):
        vcol = N + 2 * t
        ucol = N + 2 * t + 1
        xv_map.extend(slot(n + int(r), vcol) for r in rows)
        xu_map.extend(slot(n + int(r), ucol) for r in rows)
    xv_map = np.asarray(xv_map, dtype=np.int64)
    xu_map = np.asarray(xu_map, dtype=np.int64)
    # GenPow rank-3 expansion: q (dim1 rows), r (dim2 rows), p (all)
    gq_map, gr_map, gp_map_ = [], [], []
    for t in range(ngx):
        qcol = N + 2 * nx + 3 * t
        rcol = qcol + 1
        pcol = qcol + 2
        r1 = hs_plan["gpx_rows1"][t]
        r2 = hs_plan["gpx_rows2"][t]
        gq_map.extend(slot(n + int(rr), qcol) for rr in r1)
        gr_map.extend(slot(n + int(rr), rcol) for rr in r2)
        gp_map_.extend(slot(n + int(rr), pcol) for rr in r1)
        gp_map_.extend(slot(n + int(rr), pcol) for rr in r2)
    gq_map = np.asarray(gq_map, dtype=np.int64)
    gr_map = np.asarray(gr_map, dtype=np.int64)
    gp_map_ = np.asarray(gp_map_, dtype=np.int64)
    diag_map = np.asarray(
        [slot(i, i) for i in range(Next)], dtype=np.int64
    )
    nnzK = len(coords)

    # CSC-ordered pattern + permutation of the temp slots
    items = sorted(coords.items(), key=lambda kv: (kv[0][1], kv[0][0]))
    reorder = np.zeros(nnzK, dtype=np.int64)
    for new, ((i, j), old) in enumerate(items):
        reorder[old] = new
    maps = {name: (reorder[a] if a.size else a) for name, a in (
        ("p_map", p_map), ("a_map", a_map), ("diag_map", diag_map),
        ("blk_map", blk_map), ("xv_map", xv_map), ("xu_map", xu_map),
        ("gq_map", gq_map), ("gr_map", gr_map), ("gp_map", gp_map_))}
    rows_u = np.asarray([ij[0] for ij, _ in items], dtype=np.int64)
    cols_u = np.asarray([ij[1] for ij, _ in items], dtype=np.int64)
    Ap = np.zeros(Next + 1, dtype=np.int64)
    np.add.at(Ap, cols_u + 1, 1)
    Ap = np.cumsum(Ap)
    Ai = rows_u

    dsigns = np.concatenate([
        np.ones(n), -np.ones(m),
        np.tile([-1.0, 1.0], nx),        # SOC (v, u) extension signs
        np.tile([-1.0, -1.0, 1.0], ngx),  # GenPow (q, r, p) signs
    ])

    # symbolic plan with panel cap; nested-dissection ordering keeps
    # the elimination-tree chains (= level count = sequential depth)
    # short, at modestly higher fill than min-degree
    nd = nested_dissection(Next, Ap, Ai)
    sym = analyze(Next, Ap, Ai, order=nd)
    sym = _split_wide_supernodes(sym, max_width)
    plan = build_numeric_plan(sym, dsigns)
    kmap = _value_permutation(Next, Ap, Ai, sym)

    # full-pattern triplets for the refinement matvec (both triangles)
    off = rows_u != cols_u
    host_bufs = plan.device_arrays()
    host_bufs.update(maps)
    host_bufs.update({
        "kmap": kmap,
        "f_rows": np.concatenate([rows_u, cols_u[off]]),
        "f_cols": np.concatenate([cols_u, rows_u[off]]),
        "f_src": np.concatenate(
            [np.arange(nnzK, dtype=np.int64), np.nonzero(off)[0]]),
        "dsigns": dsigns,
        # SpMV triplets for the loop's residual matvecs
        "pf_rows": np.concatenate(
            [sp_prob.P_rows,
             sp_prob.P_cols[sp_prob.P_rows != sp_prob.P_cols]]),
        "pf_cols": np.concatenate(
            [sp_prob.P_cols,
             sp_prob.P_rows[sp_prob.P_rows != sp_prob.P_cols]]),
        "pf_src": np.concatenate(
            [np.arange(sp_prob.P_rows.shape[0], dtype=np.int64),
             np.nonzero(sp_prob.P_rows != sp_prob.P_cols)[0]]),
        "a_rows": sp_prob.A_rows,
        "a_cols": sp_prob.A_cols,
    })
    # true structural factor size for the info surface (the reference
    # reports nnzL via linear_solver_info, directldl_defaults.jl:66-73)
    info = {
        "method": "multifrontal",
        "kkt_dim": int(Next),
        "nnzL": int(sum(
            w * (w + 1) // 2 + w * len(sym.sn_rows[s])
            for s in range(sym.ns)
            for w in (sym.front_width(s),)
        )),
        "supernodes": int(sym.ns),
        # scheduled (width-bucketed) level count — what the numeric
        # phase walks; etree_levels is the raw etree depth
        "levels": int(plan.n_sched_levels),
        "etree_levels": len(sym.levels),
    }
    return {"plan": plan, "host_bufs": host_bufs, "info": info,
            "nnzK": nnzK, "nx": nx, "ngx": ngx, "Next": Next}


class SparseProducts:
    """P x, A x and A' z over the COO triplets, per problem, with each
    row's products summed in a fixed order (reference ipm/loop.py:
    184-202, `segment_sum`)."""

    def __init__(self, host_bufs, n, m, device):
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),  # noqa
                                      device=device)
        self.pf_src, self.pf_cols = t(host_bufs["pf_src"]), t(
            host_bufs["pf_cols"])
        self.a_rows, self.a_cols = t(host_bufs["a_rows"]), t(
            host_bufs["a_cols"])
        self.n, self.m = n, m
        self._P = SegmentSum(host_bufs["pf_rows"], n, device)
        self._A = SegmentSum(host_bufs["a_rows"], m, device)
        self._AT = SegmentSum(host_bufs["a_cols"], n, device)

    def Pmv(self, Pv, v):
        if self.pf_src.numel() == 0:
            return torch.zeros_like(v)
        return self._P(Pv.index_select(1, self.pf_src)
                       * v.index_select(1, self.pf_cols))

    def Amv(self, Av, v):
        return self._A(Av * v.index_select(1, self.a_cols))

    def ATmv(self, Av, v):
        return self._AT(Av * v.index_select(1, self.a_rows))


def make_sparse_tpu_kkt(n: int, m: int, settings, layout,
                        sp_prob: SparseProblem, max_width: int = 32,
                        device=None):
    """(factorize, solve, host_bufs) over sparse values, batched:

    factorize(Pv (B, nP), Av (B, nA), hs_parts) -> (fac, ok (B,))
    solve(fac, rx (B, n), rz (B, m)) -> (x, z, ok (B,), nir (B,))
    solve.pair(fac, rx1, rz1, rx2, rz2) -> (x1, z1, x2, z2, ok, nir)

    hs_parts is `cones.ops.sparse_hs_values`'s output.  host_bufs is
    the reference's dict of numpy index arrays; the device holds its own
    copy, built once per (problem, settings, width, device), and
    `factorize.products` carries the loop's sparse products.  Runs on
    `device` (CUDA unless the caller passes device="cpu")."""
    device = resolve_device(device)
    memo_key = (settings, max_width, str(device))
    if memo_key in sp_prob._kkt_memo:
        return sp_prob._kkt_memo[memo_key]
    host_key = (settings, max_width)
    if host_key not in sp_prob._kkt_memo:
        sp_prob._kkt_memo[host_key] = _host_analysis(n, m, layout, sp_prob,
                                                      max_width)
    h = sp_prob._kkt_memo[host_key]
    plan, host_bufs, nnzK = h["plan"], h["host_bufs"], h["nnzK"]
    nx, ngx, Next = h["nx"], h["ngx"], h["Next"]

    eps_const = settings.static_regularization_constant
    eps_prop = settings.static_regularization_proportional
    reg_enable = settings.static_regularization_enable
    dyn_enable = settings.dynamic_regularization_enable
    dyn_eps = settings.dynamic_regularization_eps
    dyn_delta = settings.dynamic_regularization_delta
    ir_enable = settings.iterative_refinement_enable
    ir_reltol = settings.iterative_refinement_reltol
    ir_abstol = settings.iterative_refinement_abstol
    ir_maxiter = settings.iterative_refinement_max_iter
    ir_stopratio = min(settings.iterative_refinement_stop_ratio, 1.2)
    # sparse "auto" stays f64 (reference-accuracy parity); "float32"
    # factors the fronts in f32, with residuals and refinement in f64
    f64 = torch.float64
    factor_dtype = (torch.float32 if settings.kkt_factor_precision
                    == "float32" else f64)

    # Memory guard: refuse a plan whose numeric phase would not fit the
    # budget (CUCLARABEL_SPARSE_HBM_BUDGET bytes, default 8e9), with an
    # error instead of an out-of-memory failure part way through a solve.
    fbytes = 4 if factor_dtype == torch.float32 else 8
    est = plan.memory_estimate_bytes(nnzK, factor_bytes=fbytes)
    budget = int(float(os.environ.get("CUCLARABEL_SPARSE_HBM_BUDGET", 8e9)))
    if est > budget:
        raise MemoryError(
            f"sparse KKT plan needs ~{est/1e9:.2f} GB of device memory "
            f"(maps + value buffer + stacked fronts) > budget "
            f"{budget/1e9:.2f} GB; refusing to start the numeric phase, "
            "which would exhaust the CUDA device's memory. Reduce the "
            "problem, improve the ordering, or raise "
            "CUCLARABEL_SPARSE_HBM_BUDGET if the device has headroom."
        )

    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),  # noqa
                                  device=device)
    maps = DeviceMaps(plan, device, factor_dtype)
    scat = {k: Scatter(host_bufs[k], device) for k in (
        "p_map", "a_map", "blk_map", "xv_map", "xu_map", "gq_map",
        "gr_map", "gp_map")}
    diag_map = t(host_bufs["diag_map"])
    kmap = t(host_bufs["kmap"])
    f_src, f_cols = t(host_bufs["f_src"]), t(host_bufs["f_cols"])
    kseg = SegmentSum(host_bufs["f_rows"], Next, device)
    dsigns = torch.as_tensor(host_bufs["dsigns"], dtype=f64, device=device)
    zext = Next - n - m

    def _kmv(fac, x):
        """K x for x (B, R, Next), K the unregularised f64 matrix."""
        B, R, _ = x.shape
        Kf = fac["Kv"].index_select(1, f_src)[:, None, :]
        prod = (Kf * x.index_select(2, f_cols)).reshape(B * R, -1)
        return kseg(prod).reshape(B, R, Next)

    def factorize(Pv, Av, hs_parts):
        hs_diag, blk_vals, socx, gpx = hs_parts
        B = Av.shape[0]
        Kv = torch.zeros(B, nnzK, dtype=f64, device=device)
        scat["p_map"].add_(Kv, Pv)
        scat["a_map"].add_(Kv, Av)
        ext_parts = [x[2] for x in socx] + [x[3] for x in gpx]
        diag_vals = [torch.zeros(B, n, dtype=f64, device=device), -hs_diag]
        Kv.index_add_(1, diag_map, torch.cat(diag_vals + ext_parts, dim=1))
        scat["blk_map"].add_(Kv, -blk_vals)
        if socx:
            scat["xu_map"].add_(Kv, torch.cat([x[0] for x in socx], dim=1))
            scat["xv_map"].add_(Kv, torch.cat([x[1] for x in socx], dim=1))
        if gpx:
            scat["gq_map"].add_(Kv, torch.cat([x[0] for x in gpx], dim=1))
            scat["gr_map"].add_(Kv, torch.cat([x[1] for x in gpx], dim=1))
            scat["gp_map"].add_(Kv, torch.cat([x[2] for x in gpx], dim=1))
        if reg_enable:
            eps = eps_const + eps_prop * Kv.index_select(
                1, diag_map).abs().amax(dim=1)
            Kv_f = Kv.index_add(1, diag_map, dsigns * eps[:, None])
        else:
            Kv_f = Kv
        fac_mf, ok = mf_factor(
            plan, Kv_f.index_select(1, kmap).to(factor_dtype), maps,
            reg_enable=dyn_enable, eps=dyn_eps, delta=dyn_delta,
        )
        return {"mf": fac_mf, "Kv": Kv}, ok

    def _raw(fac, bcols):
        """(B, R, Next) f64 -> the unrefined solution, f64."""
        return mf_solve(plan, fac["mf"], bcols.to(factor_dtype),
                        maps).to(f64)

    def _rhs(rx, rz):
        return torch.cat([rx, rz, rx.new_zeros(rx.shape[0], zext)], dim=1)

    def _refined(fac, bs):
        """Refined solves of bs (B, R, Next): the reference's seed-then-
        refine loop (sparse_tpu.py:359-453; kktsolver_directldl.jl:
        389-449) run per problem.  Its first trip is the seed solve
        (x = 0, e = b), forced accepted; afterwards a problem's right-
        hand sides are live while above tolerance, not stopped and
        finite, and a problem takes a trip while it has one live and
        trips left.  One host sync per trip (the count of problems
        still going).  Returns (x, ok (B,), nir (B,))."""
        B, R, _ = bs.shape
        normb = bs.abs().amax(dim=2)                 # (B, R)
        tol = ir_abstol + ir_reltol * normb
        x = torch.zeros_like(bs)
        e, norme = bs, normb
        it = torch.zeros(B, dtype=torch.int32, device=device)
        stop = torch.zeros(B, R, dtype=torch.bool, device=device)
        okc = torch.ones(B, R, dtype=torch.bool, device=device)
        first = True
        while True:
            if first:
                live = torch.ones_like(okc)
                run = torch.ones(B, dtype=torch.bool, device=device)
            else:
                live = ~stop & okc & (norme > tol)
                run = (it < ir_maxiter + 1) & live.any(dim=1)
                if not bool(run.any()):
                    break
            xn = x + _raw(fac, e)
            en = bs - _kmv(fac, xn)
            normen = en.abs().amax(dim=2)
            okn = torch.isfinite(normen)
            ratio = norme / torch.where(normen > 0, normen, 1e-300)
            accept = live & (first | (ratio > 1.0))
            keep = live & (first | (ratio > ir_stopratio))
            am = (accept & run[:, None])[:, :, None]
            x = torch.where(am, xn, x)
            e = torch.where(am, en, e)
            norme = torch.where(accept & run[:, None], normen, norme)
            it = torch.where(run, it + 1, it)
            stop = torch.where(run[:, None], stop | ~keep, stop)
            okc = torch.where(run[:, None] & live, okn, okc)
            first = False
        ok = (okc & torch.isfinite(norme)).all(dim=1)
        return x, ok, it - 1

    def solve(fac, rx, rz):
        # extension rows carry zero RHS (kktsolver_directldl.jl:313-343)
        b = _rhs(rx, rz)[:, None, :]
        if not ir_enable:
            x = _raw(fac, b)[:, 0]
            nir = torch.zeros(b.shape[0], dtype=torch.int32, device=device)
            return (x[:, :n], x[:, n: n + m],
                    torch.isfinite(x).all(dim=1), nir)
        x, ok, nir = _refined(fac, b)
        x = x[:, 0]
        return x[:, :n], x[:, n: n + m], ok, nir

    def solve_pair(fac, rx1, rz1, rx2, rz2):
        """Two refined solves against one factor in one level walk
        (see the dense backend's kkt_solve.pair; same per-RHS
        tolerance/acceptance semantics)."""
        bs = torch.stack([_rhs(rx1, rz1), _rhs(rx2, rz2)], dim=1)
        if not ir_enable:
            x = _raw(fac, bs)
            nir = torch.zeros(bs.shape[0], dtype=torch.int32, device=device)
            ok = torch.isfinite(x).flatten(1).all(dim=1)
        else:
            x, ok, nir = _refined(fac, bs)
        return (x[:, 0, :n], x[:, 0, n: n + m], x[:, 1, :n],
                x[:, 1, n: n + m], ok, nir)

    solve.pair = solve_pair
    factorize.linear_solver_info = dict(h["info"])
    factorize.products = SparseProducts(host_bufs, n, m, device)
    factorize.plan = plan
    sp_prob._kkt_memo[memo_key] = (factorize, solve, host_bufs)
    return factorize, solve, host_bufs
