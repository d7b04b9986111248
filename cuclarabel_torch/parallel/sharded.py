"""One large problem with its constraint rows split over several
devices.

The counterpart of `cuclarabel_tpu/parallel/sharded.py`.  The host half
is the reference's: presolve off, the rows padded so that m divides the
shard count (`_pack_rows_for_mesh`), b capped at INFINITY, Ruiz
equilibration on the host, `update_data` with the row packing, and
warm starts.  The KKT system is the block-arrow Schur complement of
`kkt/arrow.py`: A's row slabs (and the eliminated rows' D^-1 and V) sit
one per device, the m-vectors, the cone operations and the dense saddle
on the first device, and every sum over shards runs there in shard
order.  The reference falls back to a GSPMD-partitioned dense backend
when the arrow backend is refused for an m that does not divide the
mesh; the padding rules that out, and this port has no such fallback.
"""

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..cones import api
from ..cones.layout import build_layout
from ..device import shard_devices
from ..equilibration import ruiz_equilibrate
from ..infinity import get_infinity
from ..ipm.loop import make_solve_fn
from ..kkt.arrow import ShardedRows
from ..settings import Settings
from ..solver import DefaultSolution, _to_dense
from ..statuscodes import SolverStatus
from ..warmstart import scale_warm_start, validate_warm_start


def _pack_rows_for_mesh(cones, ndev):
    """Pad the constraint rows so that m divides the ndev shards
    (reference sharded.py:38-55): the original row order is kept and
    inert padding rows (0*x + s = 1 -> s = 1, z = 0) are appended.
    Returns (src_rows, new_cones): src_rows[t] = original row feeding
    new position t, or -1 for a padding row."""
    m = sum(api.nvars(c) for c in cones)
    pad = (-m) % ndev
    src_rows = np.concatenate([
        np.arange(m, dtype=np.int64),
        np.full(pad, -1, dtype=np.int64),
    ])
    new_cones = list(cones) + [api.NonnegativeConeT(1)] * pad
    return src_rows, new_cones


class ShardedSolver:
    """Solve ONE conic program with A's rows split over `n_devices`
    devices (cuda:0, cuda:1, ... unless `device` names the first; with
    device="cpu" every shard is the CPU).  The semantics of Solver
    without presolve, which is row-structural.  Asking for more cards
    than the host has raises ValueError."""

    def __init__(
        self,
        P,
        q,
        A,
        b,
        cones: Sequence[api.SupportedCone],
        settings: Optional[Settings] = None,
        n_devices: int = 1,
        device=None,
        **kwargs,
    ):
        settings = settings or Settings()
        if kwargs:
            settings = settings.replace(**kwargs)
        settings = settings.replace(presolve_enable=False)
        settings.validate()
        if settings.direct_solve_method not in ("auto", "arrow"):
            raise ValueError(
                "ShardedSolver runs the block-arrow KKT; "
                f"direct_solve_method={settings.direct_solve_method!r} has "
                "no sharded form here")
        self.settings = settings
        self.devices = shard_devices(n_devices, device)
        self.device = self.devices[0]

        q = np.asarray(q, dtype=np.float64).ravel()
        b = np.asarray(b, dtype=np.float64).ravel()
        n, m = q.shape[0], b.shape[0]
        Pd = _to_dense(P, (n, n))
        Pd = np.triu(Pd) + np.triu(Pd, 1).T
        Ad = _to_dense(A, (m, n))
        self._has_P = bool(np.any(Pd != 0.0))

        # pad the rows so that m divides the shards: inert rows
        # (0*x + s = 1 -> s = 1, z = 0) appended, the cones following
        src_rows, cones = _pack_rows_for_mesh(list(cones), n_devices)
        self._src_rows = src_rows  # new row -> orig row (-1 = padding)
        m_new = src_rows.shape[0]
        real = src_rows >= 0
        if m_new != m:
            A_new = np.zeros((m_new, n))
            A_new[real] = Ad[src_rows[real]]
            Ad = A_new
        b_new = np.ones(m_new)
        b_new[real] = b[src_rows[real]]
        # cap b at INFINITY (problemdata.jl:58-62)
        b = np.minimum(b_new, get_infinity())
        # inverse map for returning s/z in the caller's row order
        self._dst_of_orig = np.zeros(m, dtype=np.int64)
        self._dst_of_orig[src_rows[real]] = np.nonzero(real)[0]
        self._m_orig = m
        m = m_new
        self.layout = build_layout(tuple(cones))
        if self.layout.m != m:
            raise ValueError("cone dimensions inconsistent with b")
        self.n, self.m = n, m

        normq = float(np.abs(q).max()) if n else 0.0
        normb = float(np.abs(b).max()) if m else 0.0
        Pd, Ad, qs, bs, d, e, c = ruiz_equilibrate(
            Pd, Ad, q, b, self.layout, settings)
        self._d, self._e, self._c = d, e, c

        self.tp_mode = "arrow"
        self._fn = make_solve_fn(self.layout, settings, n, m, self._has_P,
                                 self.device, devices=self.devices)
        self._dev = {
            "P": self._put(Pd), "q": self._put(qs),
            "A": ShardedRows.from_host(Ad, self.devices),
            "b": self._put(bs), "d": self._put(d),
            "dinv": self._put(1.0 / d), "e": self._put(e),
            "einv": self._put(1.0 / e), "cscale": self._put(c),
            "normq": self._put(normq), "normb": self._put(normb),
        }
        self.solution: Optional[DefaultSolution] = None

    def _put(self, x) -> torch.Tensor:
        """A host array or scalar as a batch-of-one f64 tensor on the
        first device."""
        a = np.asarray(x, dtype=np.float64)[None]
        return torch.tensor(a, dtype=torch.float64, device=self.device)

    def _pack_rows(self, M, fill):
        """The row padding applied to the rows of M."""
        src = self._src_rows
        out = np.full((src.shape[0],) + M.shape[1:], fill)
        real = src >= 0
        out[real] = M[src[real]]
        return out

    def update_data(self, P=None, q=None, A=None, b=None) -> None:
        """Parametric re-solves with the stored equilibration re-applied
        (update_data!, data_updating.jl:26-158) and the row packing
        kept; the solve function is reused."""
        d, e, c = self._d, self._e, self._c
        if P is not None:
            Pd = _to_dense(P, (self.n, self.n))
            Pd = np.triu(Pd) + np.triu(Pd, 1).T
            if bool(np.any(Pd != 0.0)) != self._has_P:
                raise ValueError(
                    "update_data cannot change whether P is zero "
                    "(the solve function is specialised on it)")
            self._dev["P"] = self._put(c * (d[:, None] * Pd * d[None, :]))
        if A is not None:
            Ad = self._pack_rows(_to_dense(A, (self._m_orig, self.n)), 0.0)
            self._dev["A"] = ShardedRows.from_host(
                e[:, None] * Ad * d[None, :], self.devices)
        if q is not None:
            q = np.asarray(q, dtype=np.float64).ravel()
            if q.shape[0] != self.n:
                raise ValueError("q: wrong length")
            self._dev["q"] = self._put(c * d * q)
            self._dev["normq"] = self._put(np.abs(q).max() if self.n
                                           else 0.0)
        if b is not None:
            b = np.asarray(b, dtype=np.float64).ravel()
            if b.shape[0] != self._m_orig:
                raise ValueError("b: wrong length")
            bp = self._pack_rows(np.minimum(b, get_infinity()), 1.0)
            self._dev["b"] = self._put(e * bp)
            self._dev["normb"] = self._put(np.abs(b).max() if b.size
                                           else 0.0)

    def solve(self, warm_start=None) -> DefaultSolution:
        """warm_start=(x, s, z) in the original problem space seeds the
        iterates (see Solver.solve); symmetric-cone layouts only.  The
        padding rows start at s = 1, z = 0 (their solution: a unit z
        would dominate mu0 and erase the warm point's centrality)."""
        dev = dict(self._dev)
        if warm_start is not None:
            wx, ws, wz = validate_warm_start(self.layout, warm_start,
                                             self.n, self._m_orig)
            for key, val in zip(("ws_x", "ws_s", "ws_z"), scale_warm_start(
                    wx, self._pack_rows(ws, 1.0), self._pack_rows(wz, 0.0),
                    self._d, self._e, self._c)):
                dev[key] = self._put(val)
        dev["t_start"] = time.time()
        t0 = time.perf_counter()
        out = {k: v[0].cpu().numpy() for k, v in self._fn(dev).items()}
        sel = self._dst_of_orig
        self.solution = DefaultSolution(
            x=out["x"],
            z=out["z"][sel],
            s=out["s"][sel],
            status=SolverStatus(int(out["status"])),
            obj_val=float(out["obj_val"]),
            obj_val_dual=float(out["obj_val_dual"]),
            solve_time=time.perf_counter() - t0,
            iterations=int(out["iterations"]),
            r_prim=float(out["r_prim"]),
            r_dual=float(out["r_dual"]),
        )
        return self.solution
