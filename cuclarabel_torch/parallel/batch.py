"""Batched problem solving, on one device or data-parallel over several.

The counterpart of `cuclarabel_tpu/parallel/batch.py`: many conic
programs with the same structure (cone layout, dimensions) and different
numeric data solve together, every tensor carrying a leading batch
dimension.  Ruiz equilibration runs on the device, per problem.  The
batched path skips presolve (row elimination would give ragged shapes).

Staged batch compaction (settings.batch_compaction in (0, 1); auto
resolves to 0.9 at B >= batch_compaction_min_batch, as in the
reference): stage 1 runs the batched loop while more than a share
1 - quorum of the batch is UNSOLVED; stage 2 gathers the stragglers'
rows of the loop state and of the equilibrated data (`index_select` on
dim 0), resumes them to the end in a batch of their own width, and
scatters them back; `post` then runs once over the whole batch.  Each
problem's result is that of the plain path, which computes every
problem until the last one finishes.  Two pieces of the reference's
staged path exist only for XLA on a TPU and are left out: padding the
straggler list (and a chunked batch's tail chunk) to a power of two,
which bounds its compile cache, and re-running equilibration on the
gathered data in stage 2, which avoids moving the equilibrated data
between two compiled programs.  Here both stages run eagerly on the same
tensors.

Every cone type is covered: the exponential, power and generalised power
cones run the reference's per-problem strategy ladder (`ipm/loop.py`),
whose state moves with the stragglers like the rest.  The cone scaling
state (the PSD cones' R, Rinv and lambda among it) is recomputed from
the iterate at the start of every pass and is not part of the loop
state, so stage 2 needs nothing cone-specific.  A batch runs no chordal
decomposition (its augmentation depends on each problem's sparsity, as
the reference's batch path skips it too).

With n_devices > 1 the batch splits into equal slabs, one per device,
each solved by its own host thread with no collective (`slabs.py`;
reference batch.py:219-236).
"""

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..cones import api
from ..cones.layout import build_layout
from ..cones.segsum import Segments, segment_sum
from ..infinity import get_infinity
from ..interop import batchify, problem_from_numpy, symmetrize_triu
from ..ipm.loop import make_solve_fn, run_passes
from ..settings import Settings
from ..device import shard_devices
from ..solver import DefaultSolution
from ..statuscodes import SolverStatus
from ..warmstart import scale_warm_start, validate_warm_start
from .slabs import run_slabs, slab_bounds


def _rect_plan(layout):
    """Static segment plan for cone rectification: seg id per row of
    the m-vector for cones that need scalar equilibration, -1 elsewhere
    (rectify_equilibration!, coneops_defaults.jl:32-44)."""
    seg = np.full(layout.m, -1, dtype=np.int64)
    ranges = layout.rectification_ranges()
    for i, (lo, hi) in enumerate(ranges):
        seg[lo:hi] = i
    return seg, len(ranges)


def device_equilibrate(P, A, q, b, layout, settings, has_P=True):
    """Per-problem Ruiz equilibration (data_equilibrate!,
    src/problemdata.jl:133-221) on batched tensors P (B, n, n),
    A (B, m, n), q (B, n), b (B, m).  Returns the dict consumed by the
    IPM solve function.

    The reference chooses the scalings on an f32 shadow of the data for
    TPU speed and applies them once in f64; here the same iteration runs
    in f64 throughout, which moves the scalings by about 1e-7 relative.
    has_P=False (statically no quadratic term) skips every P-side
    computation: with P == 0 the cost scaling c stays exactly 1."""
    B, n = q.shape
    m = b.shape[1]
    zeros = q.new_zeros(B)
    normq = q.abs().amax(dim=1) if n else zeros
    normb = b.abs().amax(dim=1) if m else zeros

    d = torch.ones_like(q)
    e = torch.ones_like(b)
    c = torch.ones_like(zeros)

    if settings.equilibrate_enable:
        smin = settings.equilibrate_min_scaling
        smax = settings.equilibrate_max_scaling
        Pw, Aw, qw = P, A, q
        for _ in range(settings.equilibrate_max_iter):
            colA = Aw.abs().amax(dim=1)
            dwork = (torch.maximum(Pw.abs().amax(dim=1), colA) if has_P
                     else colA)
            ework = Aw.abs().amax(dim=2)
            dwork = 1.0 / torch.sqrt(torch.where(dwork == 0.0, 1.0, dwork))
            ework = 1.0 / torch.sqrt(torch.where(ework == 0.0, 1.0, ework))
            dwork = torch.clamp(dwork, smin / d, smax / d)
            ework = torch.clamp(ework, smin / e, smax / e)

            if has_P:
                Pw = Pw * dwork[:, None, :] * dwork[:, :, None]
            Aw = Aw * dwork[:, None, :] * ework[:, :, None]
            qw = qw * dwork
            d = d * dwork
            e = e * ework

            if has_P:
                mean_col_P = Pw.abs().amax(dim=1).mean(dim=1)
                inf_q = qw.abs().amax(dim=1)
                ctmp = 1.0 / torch.clamp(torch.maximum(inf_q, mean_col_P),
                                         min=1e-30)
                ctmp = torch.clamp(ctmp, smin / c, smax / c)
                ctmp = torch.where((mean_col_P != 0.0) & (inf_q != 0.0),
                                   ctmp, 1.0)
                Pw = Pw * ctmp[:, None, None]
                qw = qw * ctmp[:, None]
                c = c * ctmp
        # one application of the accumulated scalings to the data
        if has_P:
            P = P * (c[:, None, None] * d[:, None, :] * d[:, :, None])
        A = A * d[:, None, :] * e[:, :, None]
        q = q * (c[:, None] * d)
        b = b * e

        seg, nrect = _rect_plan(layout)
        if nrect:
            valid = np.flatnonzero(seg >= 0)
            vidx = torch.as_tensor(valid, device=q.device)
            vseg = torch.as_tensor(seg[valid], device=q.device)
            counts = torch.as_tensor(np.bincount(seg[valid], minlength=nrect),
                                     dtype=q.dtype, device=q.device)
            ev = e[:, vidx]
            mean_e = segment_sum(e, Segments(seg, q.device)) / counts
            delta = torch.ones_like(e).index_copy(1, vidx,
                                                  mean_e[:, vseg] / ev)
            A = A * delta[:, :, None]
            b = b * delta
            e = e * delta

    return {
        "P": P,
        "q": q,
        "A": A,
        "b": b,
        "d": d,
        "dinv": 1.0 / d,
        "e": e,
        "einv": 1.0 / e,
        "cscale": c,
        "normq": normq,
        "normb": normb,
    }


def _tree_map(fn, *trees):
    """fn over the leaves of matching dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def make_batch_solve_fn(layout, settings: Settings, n: int, m: int,
                        has_P: bool, device=None):
    """Batched solve: (P, A, q, b, t_start[, warm_start]) with a leading
    batch axis -> (batched solution dict of tensors, compaction record),
    on `device` (CUDA unless the caller passes device="cpu").
    warm_start=(X, S, Z) holds (B, n), (B, m), (B, m) tensors of iterates
    in the original problem space.  The record is None on the plain path
    and {"remainder", "stage1_iterations"} on the staged one (see the
    module docstring), with settings.batch_compaction resolved against
    the call's width."""
    build = make_solve_fn(layout, settings, n, m, has_P, device, parts=True)
    unsolved_code = int(SolverStatus.UNSOLVED)

    def solve_batch(P, A, q, b, t_start, warm_start=None):
        b = torch.clamp(b, max=get_infinity())  # problemdata.jl:58-62
        dev = device_equilibrate(P, A, q, b, layout, settings, has_P=has_P)
        dev["t_start"] = t_start
        if warm_start is not None:
            # cscale is (B,) here, one per problem: it scales (B, m) rows
            dev["ws_x"], dev["ws_s"], dev["ws_z"] = scale_warm_start(
                *warm_start, dev["d"], dev["e"], dev["cscale"][:, None])
        state0, loop_pass, post = build(dev)
        B = q.shape[0]
        quorum = settings.resolved_batch_compaction(B)
        if quorum <= 0.0:
            return post(run_passes(state0(), loop_pass)), None

        # stage 1: while the unsolved share is above 1 - quorum, as the
        # reference's f64 test (parallel/batch.py:304-308) puts it
        state = run_passes(state0(), loop_pass,
                           lambda left: left / B > 1.0 - quorum)
        idx = torch.nonzero(state["status"] == unsolved_code).flatten()
        comp = {"remainder": int(idx.numel()),
                "stage1_iterations": int(state["iter"].max())}
        if idx.numel():
            # stage 2: the stragglers alone, from their mid-loop state
            def take(a):
                return a.index_select(0, idx)

            dev2 = {k: take(v) if torch.is_tensor(v) else v
                    for k, v in dev.items()}
            _, loop_pass2, _ = build(dev2)
            done = run_passes(_tree_map(take, state), loop_pass2)
            state = _tree_map(lambda a, a2: a.index_copy(0, idx, a2),
                              state, done)
        return post(state), comp

    return solve_batch


class BatchSolver:
    """Solve a batch of structurally identical conic programs.

    P: (n,n) or (B,n,n); A: (m,n) or (B,m,n); q: (B,n); b: (B,m).
    All problems share the cone layout; numeric data varies freely.
    Runs on `device` (default: the current CUDA device; with no CUDA
    device this raises unless device="cpu" is passed).  With staged
    compaction or chunking, `last_compaction` records the last solve:
    {"remainder": stragglers resumed in stage 2, "stage1_iterations":
    the most iterations at the end of stage 1} when staged, plus
    {"chunks": chunk count} when chunked.

    With n_devices > 1 the batch splits in order into n_devices equal
    slabs (B must divide evenly), slab i on the i-th card from `device`
    on (every slab on the CPU with device="cpu"), and the slabs run at
    once, one host thread each, with no collective: each stops at its
    own slab's last iteration (reference batch.py:219-236).  Slab i's
    results are those of a one-device BatchSolver on slab i alone at the
    same settings.  Auto compaction and chunking resolve to 0 there;
    an explicit batch_compaction > 0 raises ValueError."""

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
        # batched path: no host presolve (shapes must stay uniform)
        settings = settings.replace(presolve_enable=False)
        settings.validate()
        if n_devices != 1 and settings.batch_compaction > 0.0:
            raise ValueError(
                "batch_compaction resumes stragglers in a narrower "
                "single-device batch and cannot combine with "
                "n_devices > 1; shard the batch OR compact it")
        self.devices = shard_devices(n_devices, device)
        self.device = self.devices[0]

        prob = problem_from_numpy(P, q, A, b, cones)
        B, n = prob["q"].shape
        m = prob["b"].shape[1]
        self.layout = build_layout(tuple(prob["cones"]))
        if self.layout.m != m:
            raise ValueError("cone dimensions inconsistent with b")
        self._bounds = slab_bounds(B, len(self.devices))
        # resolve the auto sentinel against the whole batch's width; a
        # batch over several devices neither compacts nor chunks
        # (reference batch.py:399-411)
        settings = settings.replace(batch_compaction=(
            settings.resolved_batch_compaction(B) if n_devices == 1
            else 0.0))
        self.settings = settings
        self._staged = settings.batch_compaction > 0.0
        self._has_P = bool(np.any(prob["P"] != 0.0))
        self.B, self.n, self.m = B, n, m
        self._chunk = (settings.resolved_batch_chunk(B) if n_devices == 1
                       else 0)
        self._fns = [make_batch_solve_fn(self.layout, settings, n, m,
                                         self._has_P, dev)
                     for dev in self.devices]
        self._slab_args = [tuple(self._put(prob[k][lo:hi], dev)
                                 for k in ("P", "A", "q", "b"))
                           for (lo, hi), dev in zip(self._bounds,
                                                    self.devices)]

    @staticmethod
    def _put(a, device):
        return torch.tensor(a, dtype=torch.float64, device=device)

    def update_data(self, P=None, q=None, A=None, b=None) -> None:
        """Parametric re-solves (update_data!, data_updating.jl
        semantics): equilibration runs per solve, so new data is just
        new arguments, split into the slabs; nothing is re-analysed."""
        new = {}
        if P is not None:
            Pn = symmetrize_triu(batchify(P, self.B, (self.n, self.n)))
            if bool(np.any(Pn != 0.0)) != self._has_P:
                raise ValueError(
                    "update_data cannot change whether P is zero "
                    "(the solve function is specialised on it)")
            new[0] = Pn
        if A is not None:
            new[1] = batchify(A, self.B, (self.m, self.n))
        if q is not None:
            q = np.asarray(q, dtype=np.float64)
            if q.shape != (self.B, self.n):
                raise ValueError("q must be (B, n)")
            new[2] = q
        if b is not None:
            b = np.asarray(b, dtype=np.float64)
            if b.shape != (self.B, self.m):
                raise ValueError("b must be (B, m)")
            new[3] = b
        self._slab_args = [
            tuple(self._put(new[j][lo:hi], dev) if j in new else a
                  for j, a in enumerate(args))
            for args, (lo, hi), dev in zip(self._slab_args, self._bounds,
                                           self.devices)]

    def _solve_chunked(self, t, ws):
        """Chunked wide-batch solve (settings.batch_chunk_size): the
        batch splits into chunk-wide solves run one after another, which
        bounds the live device memory by the chunk width.  A staged
        solve compacts each chunk on its own."""
        C = self._chunk
        merged = None
        comp = {"chunks": 0, "remainder": 0, "stage1_iterations": 0}
        for i in range(0, self.B, C):
            sl = slice(i, i + C)
            out, c = self._fns[0](*(a[sl] for a in self._slab_args[0]), t,
                                  tuple(w[sl] for w in ws) if ws else None)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            if merged is None:
                merged = {k: np.empty((self.B,) + v.shape[1:], v.dtype)
                          for k, v in out.items()}
            for k, v in out.items():
                merged[k][i:i + v.shape[0]] = v
            comp["chunks"] += 1
            if c is not None:
                comp["remainder"] += c["remainder"]
                comp["stage1_iterations"] = max(comp["stage1_iterations"],
                                                c["stage1_iterations"])
        if not self._staged:
            comp = {"chunks": comp["chunks"]}
        return merged, comp

    def _solve_slab(self, i, t, warm):
        """Slab i on its device -> (host result dict, compaction record);
        warm: the whole batch's host (X, S, Z) or None."""
        dev = self.devices[i]
        lo, hi = self._bounds[i]
        ws = (tuple(self._put(w[lo:hi], dev) for w in warm) if warm
              else None)
        res, comp = self._fns[i](*self._slab_args[i], t, ws)
        return {k: v.cpu().numpy() for k, v in res.items()}, comp

    def solve(self, warm_start=None):
        """Solve every problem of the batch; returns a list of
        DefaultSolution and keeps the batched result dict in self.raw.
        warm_start=(X, S, Z) with shapes (B, n), (B, m), (B, m) in the
        original problem space (e.g. stacked fields of the previous
        batch's solutions) seeds every problem's iterates, as
        Solver.solve(warm_start=...) does; symmetric-cone layouts only."""
        warm = None
        if warm_start is not None:
            warm = validate_warm_start(self.layout, warm_start, self.n,
                                       self.m, batch=self.B)
        t = time.time()
        if self._chunk:
            ws = (tuple(self._put(w, self.device) for w in warm) if warm
                  else ())
            out, comp = self._solve_chunked(t, ws)
        else:
            slabs = run_slabs(self.devices, [
                (lambda i=i: self._solve_slab(i, t, warm))
                for i in range(len(self.devices))])
            out = {k: np.concatenate([o[k] for o, _ in slabs])
                   for k in slabs[0][0]}
            comp = slabs[0][1]
        if comp is not None:
            self.last_compaction = comp
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
