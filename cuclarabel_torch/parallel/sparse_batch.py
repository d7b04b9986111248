"""Batched sparse scenario solving: many sparse conic programs that
share ONE sparsity pattern solve together on one device.

The counterpart of `cuclarabel_tpu/parallel/sparse_batch.py`.  The
level-scheduled multifrontal factorization is a chain of many small
sequential steps, so one problem is latency-bound; but every index map,
level schedule and scatter plan depends only on the PATTERN, so B
instances (different values of P/A over the same nonzeros, different
q/b) run through the whole numeric phase as one batch, every tensor
carrying a leading batch dimension, at little more latency than one.
Scenario sweeps, MPC re-solves and Monte-Carlo problem families are
exactly this shape.

Mirrors parallel/batch.py (the dense batched path) for the sparse
pipeline: per-problem sparse Ruiz equilibration over the nonzero values
on the device (data_equilibrate!, problemdata.jl:133-221 semantics),
then the sparse-KKT IPM loop over the batch.  No host presolve (batch
shapes must stay uniform) and no staged compaction — mirroring the
reference's BatchSparseSolver.  With n_devices > 1 the batch splits
into equal slabs, one per device, each solved by its own host thread
(`slabs.py`).
"""

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..cones import api
from ..cones.api import cones_collapsed
from ..cones.layout import build_layout
from ..device import shard_devices
from ..infinity import get_infinity
from ..ipm.loop import make_solve_fn
from ..kkt.scatter import SegmentSum
from ..kkt.sparse_tpu import SparseProblem, make_sparse_tpu_kkt
from ..settings import Settings
from ..solver import DefaultSolution
from ..statuscodes import SolverStatus
from ..warmstart import scale_warm_start, validate_warm_start
from .slabs import run_slabs, slab_bounds


def _seg_max(vals, idx, num):
    """Per-problem segment max of magnitudes with empty segments -> 0
    (matching the host colmax in sparse_solver.sparse_ruiz_equilibrate);
    a max does not depend on the order of its operands."""
    out = vals.new_zeros(vals.shape[0], num)
    if vals.shape[1] == 0:
        return out
    return out.scatter_reduce_(1, idx.expand(vals.shape[0], -1), vals,
                               "amax", include_self=True)


class _EquilibrationMaps:
    """The COO index maps of device_sparse_equilibrate on one device."""

    def __init__(self, host_bufs, sp_prob, layout, device):
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),  # noqa
                                      device=device)
        self.pe_rows, self.pe_cols = t(sp_prob.P_rows), t(sp_prob.P_cols)
        self.pf_cols, self.pf_src = t(host_bufs["pf_cols"]), t(
            host_bufs["pf_src"])
        self.a_rows, self.a_cols = t(sp_prob.A_rows), t(sp_prob.A_cols)
        rect = layout.rectification_ranges()
        self.rect = None
        if rect:
            rows = np.concatenate([np.arange(lo, hi) for lo, hi in rect])
            seg = np.concatenate([np.full(hi - lo, i)
                                  for i, (lo, hi) in enumerate(rect)])
            counts = np.asarray([hi - lo for lo, hi in rect],
                                dtype=np.float64)
            self.rect = (t(rows), t(seg), SegmentSum(seg, len(rect), device),
                         torch.as_tensor(counts, device=device))


def device_sparse_equilibrate(Pv, Av, q, b, maps, n, m, settings):
    """Per-problem sparse Ruiz equilibration over nonzero values (the
    reference's device_sparse_equilibrate, sparse_batch.py:49-136, over
    a leading batch B): Ruiz iterations with min/max scaling clips, cost
    scaling c, and cone rectification.  Pv (B, nnz(triu P)), Av
    (B, nnz(A)), q (B, n), b (B, m); maps: _EquilibrationMaps."""
    B = q.shape[0]
    zeros = q.new_zeros(B)
    normq = q.abs().amax(dim=1) if n else zeros
    normb = b.abs().amax(dim=1) if m else zeros

    d = torch.ones_like(q)
    e = torch.ones_like(b)
    c = torch.ones_like(zeros)
    if not settings.equilibrate_enable:
        return {"Pv": Pv, "Av": Av, "q": q, "b": b, "d": d, "dinv": d,
                "e": e, "einv": e, "cscale": c, "normq": normq,
                "normb": normb}

    smin = settings.equilibrate_min_scaling
    smax = settings.equilibrate_max_scaling
    hasP = Pv.shape[1] > 0

    def colmax_P(Pv):
        return _seg_max(Pv.index_select(1, maps.pf_src).abs(),
                        maps.pf_cols, n)

    for _ in range(settings.equilibrate_max_iter):
        aA = Av.abs()
        cA = _seg_max(aA, maps.a_cols, n)
        rA = _seg_max(aA, maps.a_rows, m)
        dwork = torch.maximum(colmax_P(Pv), cA) if hasP else cA
        dwork = 1.0 / torch.sqrt(torch.where(dwork == 0.0, 1.0, dwork))
        ework = 1.0 / torch.sqrt(torch.where(rA == 0.0, 1.0, rA))
        dwork = torch.clamp(dwork, smin / d, smax / d)
        ework = torch.clamp(ework, smin / e, smax / e)

        if hasP:
            Pv = (Pv * dwork.index_select(1, maps.pe_rows)
                  * dwork.index_select(1, maps.pe_cols))
        Av = (Av * ework.index_select(1, maps.a_rows)
              * dwork.index_select(1, maps.a_cols))
        q = q * dwork
        b = b * ework
        d = d * dwork
        e = e * ework

        mean_col_P = colmax_P(Pv).mean(dim=1) if hasP else zeros
        inf_q = q.abs().amax(dim=1) if n else zeros
        ctmp = 1.0 / torch.clamp(torch.maximum(inf_q, mean_col_P),
                                 min=1e-300)
        ctmp = torch.clamp(ctmp, smin / c, smax / c)
        ctmp = torch.where((mean_col_P != 0.0) & (inf_q != 0.0), ctmp, 1.0)
        if hasP:
            Pv = Pv * ctmp[:, None]
        q = q * ctmp[:, None]
        c = c * ctmp

    # cone rectification: non-elementwise cones get their rows'
    # scalings replaced by the block mean (rectify_equilibration!,
    # coneops_defaults.jl:32-44)
    if maps.rect is not None:
        rows, seg, segsum, counts = maps.rect
        blk = e.index_select(1, rows)
        mean = segsum(blk) / counts
        delta = torch.ones_like(e).index_copy(
            1, rows, mean.index_select(1, seg) / blk)
        Av = Av * delta.index_select(1, maps.a_rows)
        b = b * delta
        e = e * delta

    return {"Pv": Pv, "Av": Av, "q": q, "b": b, "d": d, "dinv": 1.0 / d,
            "e": e, "einv": 1.0 / e, "cscale": c, "normq": normq,
            "normb": normb}


class BatchSparseSolver:
    """Solve a batch of sparse conic programs sharing one pattern.

    P: scipy sparse (n,n) or None; A: scipy sparse (m,n) — these fix
    the PATTERN and the default values.  q: (B,n); b: (B,m).
    P_vals/A_vals: optional (B, nnz) per-problem nz values over the
    same pattern (nnz of triu(P) in CSC-COO order as produced by
    SparseProblem.P_vals / A_vals).  Runs on `device` (CUDA unless the
    caller passes device="cpu").  With n_devices > 1 the batch splits
    into equal slabs, one per card from `device` on (every slab on the
    CPU with device="cpu"), each solved by its own host thread, as
    BatchSolver's are; the host symbolic analysis runs once and its
    index maps are copied to each card.

    Cone coverage matches SparseSolver."""

    def __init__(self, P, q, A, b, cones: Sequence[api.SupportedCone],
                 settings: Optional[Settings] = None,
                 P_vals=None, A_vals=None, n_devices: int = 1,
                 device=None, **kwargs):
        import scipy.sparse as sp

        settings = settings or Settings()
        if kwargs:
            settings = settings.replace(**kwargs)
        settings = settings.replace(presolve_enable=False)
        settings.validate()
        self.settings = settings
        self.devices = shard_devices(n_devices, device)
        self.device = self.devices[0]

        q = np.asarray(q, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if q.ndim != 2 or b.ndim != 2 or q.shape[0] != b.shape[0]:
            raise ValueError("q must be (B,n) and b (B,m) with equal B")
        B, n = q.shape
        m = b.shape[1]
        if A.shape != (m, n):
            raise ValueError("A shape inconsistent with q/b")
        self._bounds = slab_bounds(B, len(self.devices))

        cones = cones_collapsed(list(cones))
        self.layout = build_layout(tuple(cones))
        if self.layout.m != m:
            raise ValueError("cone dimensions inconsistent with b")
        has_P = P is not None and sp.csc_matrix(P).nnz > 0
        self._sp = SparseProblem.from_scipy(P if has_P else None, A)
        self._has_P = has_P
        self.B, self.n, self.m = B, n, m

        Pv0 = self._sp.P_vals(P if has_P else None)
        Av0 = self._sp.A_vals(A)

        def batch_vals(V, V0, what):
            if V is None:
                return np.broadcast_to(V0, (B,) + V0.shape)
            V = np.asarray(V, dtype=np.float64)
            if V.shape != (B,) + V0.shape:
                raise ValueError(
                    f"{what} must be (B, {V0.shape[0]}), got {V.shape}")
            return V

        # one host analysis (memoised on the SparseProblem); each device
        # gets its own copy of the index maps
        self._maps, self._fns = [], []
        for dev in self.devices:
            _, _, host_bufs = make_sparse_tpu_kkt(n, m, settings,
                                                  self.layout, self._sp,
                                                  device=dev)
            self._maps.append(_EquilibrationMaps(host_bufs, self._sp,
                                                 self.layout, dev))
            self._fns.append(make_solve_fn(self.layout, settings, n, m,
                                           has_P, dev, sparse=self._sp))
        full = (batch_vals(P_vals, Pv0, "P_vals"),
                batch_vals(A_vals, Av0, "A_vals"), q, b)
        self._slab_args = [tuple(self._put(a[lo:hi], dev) for a in full)
                           for (lo, hi), dev in zip(self._bounds,
                                                    self.devices)]
        self.raw = None

    @staticmethod
    def _put(a, device):
        return torch.tensor(np.asarray(a), dtype=torch.float64,
                            device=device)

    def update_data(self, q=None, b=None, P_vals=None, A_vals=None):
        """Parametric re-solve path (data_updating.jl semantics for the
        batched-values case): replace per-problem q/b/nz values without
        re-analysis.  Shapes must match the original batch."""
        B = self.B
        new = {}
        for j, (v, what) in enumerate(((P_vals, "P_vals"),
                                       (A_vals, "A_vals"), (q, "q"),
                                       (b, "b"))):
            if v is None:
                continue
            v = np.asarray(v, dtype=np.float64)
            want = (B,) + tuple(self._slab_args[0][j].shape[1:])
            if v.shape != want:
                raise ValueError(
                    f"{what} must have shape {want}, got {v.shape}")
            new[j] = v
        self._slab_args = [
            tuple(self._put(new[j][lo:hi], dev) if j in new else a
                  for j, a in enumerate(args))
            for args, (lo, hi), dev in zip(self._slab_args, self._bounds,
                                           self.devices)]

    def _solve_slab(self, i, t, warm):
        """Slab i on its device -> host result dict; warm: the whole
        batch's host (X, S, Z) or None."""
        dev_i = self.devices[i]
        lo, hi = self._bounds[i]
        Pv, Av, q, b = self._slab_args[i]
        dev = device_sparse_equilibrate(
            Pv, Av, q, torch.clamp(b, max=get_infinity()), self._maps[i],
            self.n, self.m, self.settings)
        dev["t_start"] = t
        if warm is not None:
            dev["ws_x"], dev["ws_s"], dev["ws_z"] = scale_warm_start(
                *(self._put(w[lo:hi], dev_i) for w in warm), dev["d"],
                dev["e"], dev["cscale"][:, None])
        return {k: v.cpu().numpy() for k, v in self._fns[i](dev).items()}

    def solve(self, warm_start=None):
        """Solve every problem; returns a list of DefaultSolution and
        keeps the batched result dict in self.raw.  warm_start=(X, S, Z),
        shapes (B, n)/(B, m)/(B, m) in the original problem space, seeds
        every problem's iterates (see Solver.solve); symmetric-cone
        layouts only."""
        warm = None
        if warm_start is not None:
            warm = validate_warm_start(self.layout, warm_start, self.n,
                                       self.m, batch=self.B)
        t = time.time()
        slabs = run_slabs(self.devices, [
            (lambda i=i: self._solve_slab(i, t, warm))
            for i in range(len(self.devices))])
        out = {k: np.concatenate([o[k] for o in slabs]) for k in slabs[0]}
        sols = []
        for i in range(self.B):
            sols.append(
                DefaultSolution(
                    x=out["x"][i],
                    z=out["z"][i],
                    s=out["s"][i],
                    status=SolverStatus(int(out["status"][i])),
                    obj_val=float(out["obj_val"][i]),
                    obj_val_dual=float(out["obj_val_dual"][i]),
                    solve_time=0.0,
                    iterations=int(out["iterations"][i]),
                    r_prim=float(out["r_prim"][i]),
                    r_dual=float(out["r_dual"][i]),
                )
            )
        self.raw = out
        return sols
