"""Device-side sparse LDL^T: level-scheduled batched multifrontal.

The counterpart of `cuclarabel_tpu/kkt/sparse_device.py` (the sparse
direct solver of the device path; the reference's counterpart is the
QDLDL backend, directldl_qdldl.jl:10-96).  Design:

  * host symbolic analysis (sparse_symbolic.py) produces supernodes and
    a level schedule; all supernodes of one level are independent;
  * the numeric phase walks the levels: per level the frontal matrices
    are assembled from precomputed flat index maps over the K values and
    the child-update buffer, a batched dense partial-LDL^T with signed
    dynamic regularization (QDLDL semantics, directldl_qdldl.jl:18-25)
    eliminates the panel columns, and the Schur complement goes through
    one batched matmul into the flat update buffer;
  * the triangular solves walk the levels with the same maps.

The host plan (`_GroupPlan`, `NumericPlan`, `_choose_groups`,
`build_numeric_plan`, `_split_wide_supernodes`, `_value_permutation`)
is a copy of the reference's numpy code, so `NumericPlan.device_arrays()`
is the reference's array for array.  The numeric phase is plain torch,
run eagerly, over a leading batch dimension: values (B, nnz), panels
(B, nl, kq, fq, wq) per group, Dinv (B, N + 1).  The reference runs one
problem per jitted program and `vmap`s it; here the batch is explicit,
so `SparseDeviceLDL` at B = 1 serves `SparseSolver` and at B problems
`BatchSparseSolver`.  The groups keep their padded shapes; the level
loop is a Python loop, since nothing here is compiled.

Where the reference adds into a target that repeats within one scatter
(the front assembly, the solve's trailing updates), the additions run
in rounds of distinct targets (`kkt/scatter.py`), so that two
factorizations of the same values are bitwise equal on the card.
"""

import dataclasses
import os
from typing import List

import numpy as np
import torch

from ..device import resolve_device
from .scatter import Scatter
from .sparse_symbolic import SymbolicPlan, analyze


@dataclasses.dataclass
class _GroupPlan:
    """A contiguous run of levels sharing one padded shape; all member
    arrays are stacked with leading dim nl = hi - lo."""

    lo: int
    hi: int
    kq: int                 # padded front count per level
    fq: int                 # padded front size (kq fronts of fq rows)
    wq: int                 # padded panel width
    # assembly: unified value buffer [Kv | ubuf | trash] -> panel /
    # F22 slots, (nl, Lmax) each, padded with src=0 / dst=trash.
    # Merging the K-entry and child-update scatters into one per
    # target halves the scatter count per level step (batched scatter
    # is the compile-time driver under vmap).
    p_src: np.ndarray
    p_dst: np.ndarray
    s2_src: np.ndarray
    s2_dst: np.ndarray
    # update write-back: F22 slots -> ubuf positions
    w_src: np.ndarray
    w_dst: np.ndarray
    # per-level per-front-column metadata
    cg: np.ndarray          # (nl, kq*wq) global col ids; padding -> N
    dsign: np.ndarray       # (nl, kq, wq) signs; padding -> +1
    pad: np.ndarray         # (nl, kq, wq) 1.0 on identity-pad columns
    gidx: np.ndarray        # (nl, kq, fq) global row ids; padding -> N

    @property
    def nl(self) -> int:
        return self.hi - self.lo

    @property
    def rq(self) -> int:
        return self.fq - self.wq


@dataclasses.dataclass
class NumericPlan:
    sym: SymbolicPlan
    groups: List[_GroupPlan]
    ubuf_size: int
    N: int
    # scheduled level count AFTER width bucketing (what the compiled
    # program actually walks; len(sym.levels) is the pre-split etree
    # level count)
    n_sched_levels: int = 0

    def memory_estimate_bytes(self, nnzK: int, factor_bytes: int = 4):
        """Device-memory footprint estimate of one numeric
        factorization: index maps (runtime inputs) + the unified value
        buffer (at the factor dtype width, with a 4x allowance — the
        level scan's loop-carried copy, the scatter's operand/result
        pair, and slack for XLA temporaries) + the largest per-group
        stacked fronts/panels (2x for double-buffering).  Used by the
        HBM guard in sparse_tpu.py — a dispatch whose plan exceeds the
        budget previously CRASHED the v5e worker (round-2 N=20001
        incident) instead of failing cleanly."""
        maps = sum(a.nbytes for a in self.device_arrays().values())
        vbuf = (nnzK + self.ubuf_size + 1) * factor_bytes
        fronts = max(
            (g.nl * g.kq * g.fq * max(g.wq, 1) * factor_bytes
             + g.nl * g.kq * g.rq * g.rq * factor_bytes
             for g in self.groups),
            default=0,
        )
        return int(maps + 4 * vbuf + 2 * fronts)

    def device_arrays(self):
        """Index maps as a flat dict of numpy arrays.  These are passed
        into the jitted numeric phase as RUNTIME INPUTS, not baked
        constants: at N ~ 10^4 the maps total tens of MB and baking
        them into the program text OOMs the compiler (observed
        SIGKILLed remote compile at a 9 MB MLIR module)."""
        bufs = {"perm": self.sym.perm, "iperm": self.sym.iperm}
        for i, gp in enumerate(self.groups):
            for name in ("p_src", "p_dst", "s2_src", "s2_dst",
                         "w_src", "w_dst", "cg", "dsign", "pad",
                         "gidx"):
                bufs[f"g{i}_{name}"] = getattr(gp, name)
        return bufs


def _choose_groups(shapes, lam=200_000):
    """Optimal contiguous partition of levels into groups, minimizing
    padded work + map memory + lam per group (lam models the per-body
    compile cost).  shapes: list of (k, w, r, maplens-tuple)."""
    n = len(shapes)
    if n == 0:
        return []

    def cost(i, j):
        kq = max(s[0] for s in shapes[i:j])
        wq = max(s[1] for s in shapes[i:j])
        rq = max(s[2] for s in shapes[i:j])
        mlen = sum(
            max(s[3][t] for s in shapes[i:j])
            for t in range(len(shapes[i][3]))
        )
        return (j - i) * (kq * (wq + rq) * wq + kq * rq * rq // 4
                          + mlen)

    best = [0.0] * (n + 1)
    prev = [0] * (n + 1)
    for j in range(1, n + 1):
        best[j] = float("inf")
        for i in range(j):
            c = best[i] + cost(i, j) + lam
            if c < best[j]:
                best[j] = c
                prev[j] = i
    bounds = []
    j = n
    while j > 0:
        i = prev[j]
        bounds.append((i, j))
        j = i
    return list(reversed(bounds))


def build_numeric_plan(sym: SymbolicPlan, dsigns: np.ndarray,
                       group_lambda: int = None) -> NumericPlan:
    """dsigns: (N,) quasidefinite signs in the ORIGINAL ordering.

    group_lambda tunes the level-grouping DP's per-group penalty
    (compile-cost model): larger -> fewer scan groups -> faster
    compiles at more padded runtime work.  Default 200_000, overridable
    via CUCLARABEL_SPARSE_GROUP_LAMBDA."""
    if group_lambda is None:
        group_lambda = int(
            os.environ.get("CUCLARABEL_SPARSE_GROUP_LAMBDA", "200000"))
    N = sym.N
    ds_perm = np.asarray(dsigns, dtype=np.float64)[sym.perm]

    # global front-local index lookup per snode
    sn_front: List[np.ndarray] = []
    sn_pos = {}  # (snode, global idx) -> position within the front ids
    for s in range(sym.ns):
        c0, c1 = int(sym.sn_starts[s]), int(sym.sn_starts[s + 1])
        idx = np.concatenate([
            np.arange(c0, c1, dtype=np.int64), sym.sn_rows[s]
        ])
        sn_front.append(idx)
        for t, g in enumerate(idx):
            sn_pos[(s, int(g))] = t

    col2sn = np.zeros(N, dtype=np.int64)
    for s in range(sym.ns):
        col2sn[sym.sn_starts[s]: sym.sn_starts[s + 1]] = s

    # update-buffer offsets
    uoff = np.zeros(sym.ns + 1, dtype=np.int64)
    for s in range(sym.ns):
        uoff[s + 1] = uoff[s] + len(sym.sn_rows[s]) ** 2
    ubuf_size = int(uoff[-1])

    # group K entries by owning snode (snode of the row index = min)
    Ap, Ai = sym.Ap, sym.Ai
    ent_by_sn: List[List] = [[] for _ in range(sym.ns)]
    for j in range(N):
        for p in range(Ap[j], Ap[j + 1]):
            i = int(Ai[p])          # i <= j
            s = int(col2sn[i])
            ent_by_sn[s].append((p, i, j))

    # ---- per-level raw shapes + map lengths for the grouping DP ----
    def _lev_shape(lev_sns):
        widths = [sym.front_width(int(s)) for s in lev_sns]
        rlens = [len(sym.sn_rows[int(s)]) for s in lev_sns]
        nkp = nk2 = nup = nu2 = nw = 0
        for s in (int(x) for x in lev_sns):
            w = sym.front_width(s)
            for (_, i, j) in ent_by_sn[s]:
                # upper bound: both mirrors could land in the panel
                nkp += 2
            for c in np.nonzero(sym.sn_parent == s)[0]:
                rc = len(sym.sn_rows[int(c)])
                nup += rc * rc
            nw += len(sym.sn_rows[s]) ** 2
        nk2 = nkp
        nu2 = nup
        return (len(lev_sns), max(widths),
                max(rlens) if rlens else 0,
                (nkp, nk2, nup, nu2, nw))

    # ---- width-bucketed levels (round-5 fix) ------------------------
    # A level's fronts all pad to the level maximum; one wide supernode
    # sharing a level with hundreds of tiny leaves multiplies the
    # stacked-front buffers catastrophically (CVXQP1_M: level 0 held
    # 1320 fronts padded to 589x589 — a 7 GB plan whose XLA lowering
    # materialized ~4 copies and OOMed 16 GB HBM at COMPILE).
    # Same-level snodes are independent, so each level splits into
    # size-sorted buckets with max/min padded-front ratio <= 2 (floor
    # 16): padding is bounded, and the sorted sub-levels are adjacent
    # and similar so the group DP re-merges them cheaply.
    def _split_wide_levels(levels):
        out = []
        for ls in levels:
            ls = np.asarray(ls)
            if len(ls) <= 1:
                out.append(ls)
                continue
            szs = np.array([
                sym.front_width(int(s)) + len(sym.sn_rows[int(s)])
                for s in ls
            ])
            order = np.argsort(szs, kind="stable")
            ls_sorted = ls[order]
            szs_sorted = szs[order]
            start = 0
            for i in range(1, len(ls_sorted) + 1):
                if i == len(ls_sorted) or szs_sorted[i] > 2 * max(
                    int(szs_sorted[start]), 16
                ):
                    out.append(ls_sorted[start:i])
                    start = i
        return out

    levels = _split_wide_levels(sym.levels)

    shapes = [_lev_shape(ls) for ls in levels]
    bounds = _choose_groups(shapes, lam=group_lambda)

    groups: List[_GroupPlan] = []
    for (glo, ghi) in bounds:
        kq = max(shapes[l][0] for l in range(glo, ghi))
        wq = max(shapes[l][1] for l in range(glo, ghi))
        rq = max(shapes[l][2] for l in range(glo, ghi))
        fq = wq + rq
        trash_p = kq * fq * wq
        trash_2 = kq * rq * rq

        nnzK = int(sym.Ai.shape[0])
        per_level = {name: [] for name in (
            "p_src", "p_dst", "s2_src", "s2_dst", "w_src", "w_dst")}
        cg_all, dsign_all, pad_all, gidx_all = [], [], [], []

        for l in range(glo, ghi):
            lev_sns = levels[l]
            kp_src, kp_dst = [], []
            k2_src, k2_dst = [], []
            up_src, up_dst = [], []
            u2_src, u2_dst = [], []
            w_src, w_dst = [], []
            col_gid = np.full((kq, wq), -1, dtype=np.int64)
            dsign = np.ones((kq, wq), dtype=np.float64)
            gidx = np.full((kq, fq), N, dtype=np.int64)

            for fi, s in enumerate(int(x) for x in lev_sns):
                w = sym.front_width(s)
                c0 = int(sym.sn_starts[s])

                # local slot of global g within the PADDED front
                def slot(g):
                    t = sn_pos[(s, int(g))]
                    return t if t < w else wq + (t - w)

                for t, g in enumerate(sn_front[s]):
                    gidx[fi, slot(g)] = int(g)
                col_gid[fi, :w] = np.arange(c0, c0 + w)
                dsign[fi, :w] = ds_perm[c0: c0 + w]

                base_p = fi * fq * wq
                base_2 = fi * rq * rq

                def emit(src, li, lj):
                    """Route one (row li, col lj) slot: panel if the
                    column is eliminated here, F22 if both are trailing
                    rows; the F12 mirror (panel row, trailing col) is
                    never read by the blocked elimination — dropped."""
                    if lj < wq:
                        kp_src.append(src)
                        kp_dst.append(base_p + li * wq + lj)
                    elif li >= wq:
                        k2_src.append(src)
                        k2_dst.append(base_2 + (li - wq) * rq
                                      + (lj - wq))

                # K entries (both mirrors so the panel's diagonal block
                # is held full-symmetric for the rank-1 elimination)
                for (p, i, j) in ent_by_sn[s]:
                    li, lj = slot(i), slot(j)
                    emit(p, li, lj)
                    if li != lj:
                        emit(p, lj, li)
                # children updates (vectorized: r^2-sized, dominate
                # host planning time at large N)
                for c in np.nonzero(sym.sn_parent == s)[0]:
                    rows_c = sym.sn_rows[int(c)]
                    rc = len(rows_c)
                    slots = np.asarray([slot(g) for g in rows_c],
                                       dtype=np.int64)
                    csrc = int(uoff[c]) + np.arange(rc * rc,
                                                    dtype=np.int64)
                    dst_li = np.repeat(slots, rc)
                    dst_lj = np.tile(slots, rc)
                    in_panel = dst_lj < wq
                    in_f22 = (~in_panel) & (dst_li >= wq)
                    up_src.append(csrc[in_panel])
                    up_dst.append(base_p + dst_li[in_panel] * wq
                                  + dst_lj[in_panel])
                    u2_src.append(csrc[in_f22])
                    u2_dst.append(base_2 + (dst_li[in_f22] - wq) * rq
                                  + (dst_lj[in_f22] - wq))
                # update write-back (F22 after the Schur update)
                r = len(sym.sn_rows[s])
                rr = np.arange(r, dtype=np.int64)
                w_src.append(
                    (base_2 + rr[:, None] * rq + rr[None, :]).ravel()
                )
                w_dst.append(int(uoff[s])
                             + np.arange(r * r, dtype=np.int64))

            def _cat(parts):
                return (
                    np.concatenate(parts) if len(parts)
                    else np.zeros(0, dtype=np.int64)
                )

            # unified value buffer [Kv | ubuf | trash]: child-update
            # sources shift by nnzK, then one scatter per target
            per_level["p_src"].append(np.concatenate(
                [np.asarray(kp_src, np.int64), _cat(up_src) + nnzK]
            ))
            per_level["p_dst"].append(np.concatenate(
                [np.asarray(kp_dst, np.int64), _cat(up_dst)]
            ))
            per_level["s2_src"].append(np.concatenate(
                [np.asarray(k2_src, np.int64), _cat(u2_src) + nnzK]
            ))
            per_level["s2_dst"].append(np.concatenate(
                [np.asarray(k2_dst, np.int64), _cat(u2_dst)]
            ))
            per_level["w_src"].append(_cat(w_src))
            per_level["w_dst"].append(_cat(w_dst))
            cg_all.append(np.where(col_gid < 0, N, col_gid)
                          .reshape(-1))
            dsign_all.append(dsign)
            pad_all.append((col_gid < 0).astype(np.float64))
            gidx_all.append(gidx)

        # pad ragged maps to the group max length; padding entries
        # read src 0 and write a trash slot
        def _stack(name, trash):
            arrs = per_level[name]
            L = max((a.size for a in arrs), default=0)
            out = np.full((ghi - glo, L), trash, dtype=np.int64)
            for t, a in enumerate(arrs):
                out[t, : a.size] = a
            return out.astype(np.int32)

        groups.append(_GroupPlan(
            lo=glo, hi=ghi, kq=kq, fq=fq, wq=wq,
            p_src=_stack("p_src", 0),
            p_dst=_stack("p_dst", trash_p),
            s2_src=_stack("s2_src", 0),
            s2_dst=_stack("s2_dst", trash_2),
            w_src=_stack("w_src", 0),
            w_dst=_stack("w_dst", ubuf_size),
            cg=np.stack(cg_all).astype(np.int32),
            dsign=np.stack(dsign_all),
            pad=np.stack(pad_all),
            gidx=np.stack(gidx_all).astype(np.int32),
        ))

    return NumericPlan(sym=sym, groups=groups,
                       ubuf_size=ubuf_size, N=N,
                       n_sched_levels=len(levels))


# ---------------------------------------------------------------------
# numeric phase (torch, batched)
# ---------------------------------------------------------------------

@dataclasses.dataclass
class _Level:
    """One scheduled level's maps on the device, padding stripped."""

    p_scatter: Scatter       # [Kv | ubuf] -> panel slots (kq*fq*wq)
    s2_scatter: Scatter      # [Kv | ubuf] -> F22 slots (kq*rq*rq)
    p_src: torch.Tensor
    s2_src: torch.Tensor
    w_src: torch.Tensor      # F22 slots -> ubuf positions (distinct)
    w_dst: torch.Tensor
    pad_pos: torch.Tensor    # flat panel slots of identity-pad diagonals
    col_pos: torch.Tensor    # real panel columns (flat kq*wq) ...
    col_gid: torch.Tensor    # ... and their global column ids
    dsign: torch.Tensor      # (kq, wq) factor dtype
    gidx: torch.Tensor       # (kq, fq) global row ids; padding -> N
    t_scatter: Scatter       # trailing rows (flat kq*rq, real) -> x
    t_pos: torch.Tensor


class DeviceMaps:
    """A NumericPlan's index maps placed on one device, once: per group
    its shape and per level a `_Level`.  Built from
    `plan.device_arrays()`, so the maps that reach the device are the
    reference's."""

    def __init__(self, plan: "NumericPlan", device, dtype=torch.float64):
        device = torch.device(device)
        self.device, self.dtype = device, dtype
        bufs = plan.device_arrays()
        N = plan.N
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),  # noqa
                                      device=device)
        self.perm = t(bufs["perm"])
        self.iperm = t(bufs["iperm"])
        self.groups = []
        for gi, gp in enumerate(plan.groups):
            kq, fq, wq, rq = gp.kq, gp.fq, gp.wq, gp.rq
            trash_p, trash_2 = kq * fq * wq, kq * rq * rq
            levels = []
            for li in range(gp.nl):
                g = lambda name: np.asarray(bufs[f"g{gi}_{name}"][li])  # noqa
                p_dst, s2_dst, w_dst = g("p_dst"), g("s2_dst"), g("w_dst")
                keep_p = p_dst != trash_p
                keep_2 = s2_dst != trash_2
                keep_w = w_dst != plan.ubuf_size
                pad = g("pad").astype(bool)           # (kq, wq)
                fi, jj = np.nonzero(pad)
                cg = g("cg").reshape(kq, wq)
                real = cg < N
                gidx = g("gidx").astype(np.int64)     # (kq, fq)
                trail = gidx[:, wq:].reshape(-1)
                t_real = np.nonzero(trail < N)[0]
                levels.append(_Level(
                    p_scatter=Scatter(p_dst[keep_p], device),
                    s2_scatter=Scatter(s2_dst[keep_2], device),
                    p_src=t(g("p_src")[keep_p]),
                    s2_src=t(g("s2_src")[keep_2]),
                    w_src=t(g("w_src")[keep_w]),
                    w_dst=t(w_dst[keep_w]),
                    pad_pos=t(fi * fq * wq + jj * wq + jj),
                    col_pos=t(np.nonzero(real.reshape(-1))[0]),
                    col_gid=t(cg[real]),
                    dsign=torch.as_tensor(g("dsign"), dtype=dtype,
                                          device=device),
                    gidx=t(gidx),
                    t_scatter=Scatter(trail[t_real], device),
                    t_pos=t(t_real),
                ))
            self.groups.append((gp, levels))


def factor(plan: NumericPlan, Kv, maps: DeviceMaps, *, reg_enable=True,
           eps=1e-13, delta=2e-7):
    """Kv: (B, nnz) values of the permuted upper pattern in the factor
    dtype; maps: the plan's DeviceMaps.  Returns (fac, ok (B,)): fac
    holds per-group stacked factored panels (B, nl, kq, fq, wq) and Dinv
    (B, N + 1).  Nothing here reads a value back to the host."""
    N = plan.N
    B, nnzK = Kv.shape
    dt = Kv.dtype
    # unified value buffer [Kv | ubuf] (the reference's trash slot is
    # not needed: the maps' padding is stripped)
    vals = torch.cat([Kv, Kv.new_zeros(B, plan.ubuf_size)], dim=1)
    Dinv = Kv.new_zeros(B, N + 1)
    fronts_out = []
    ok = torch.ones(B, dtype=torch.bool, device=Kv.device)

    for gp, levels in maps.groups:
        kq, fq, wq, rq = gp.kq, gp.fq, gp.wq, gp.rq
        panels = Kv.new_zeros(B, gp.nl, kq, fq, wq)
        for li, lv in enumerate(levels):
            Fp = panels[:, li]
            flat = Fp.view(B, kq * fq * wq)
            lv.p_scatter.add_(flat, vals.index_select(1, lv.p_src))
            if lv.pad_pos.numel():
                # identity-pad the unused column slots
                flat.index_fill_(1, lv.pad_pos, 1.0)
            if reg_enable:
                regv = lv.dsign * delta
            for j in range(wq):
                dj = Fp[:, :, j, j]
                if reg_enable:
                    # with eps > 0, a zero pivot fails the sign test too
                    bad = lv.dsign[:, j] * dj < eps
                    if eps <= 0.0:
                        bad = bad | (dj == 0.0)
                    dj = torch.where(bad, regv[:, j], dj)
                else:
                    dj = dj.clone()         # the column is scaled in place
                col = Fp[:, :, :, j]                     # (B, kq, fq)
                dinv = (1.0 / dj)[:, :, None]
                if j + 1 < wq:
                    # the reference's lcol * gt times col, on the
                    # columns right of j alone
                    lrow = col[:, :, j + 1:wq] * dinv
                    Fp[:, :, :, j + 1:].addcmul_(
                        col[:, :, :, None], lrow[:, :, None, :], value=-1.0)
                col.mul_(dinv)                  # L's column in place
                Fp[:, :, j, j] = dj             # D on the diagonal slot
            d = torch.diagonal(Fp[:, :, :wq, :], dim1=2, dim2=3)  # (B,kq,wq)
            ok = ok & (d != 0.0).flatten(1).all(dim=1)
            Dinv.index_copy_(1, lv.col_gid,
                             (1.0 / d).reshape(B, -1).index_select(
                                 1, lv.col_pos))
            if rq:
                F2 = Kv.new_zeros(B, kq * rq * rq)
                lv.s2_scatter.add_(F2, vals.index_select(1, lv.s2_src))
                F2 = F2.view(B * kq, rq, rq)
                # Schur complement in one batched matmul:
                # F22 -= L21 D L21^T
                L21 = Fp[:, :, wq:, :].reshape(B * kq, rq, wq)
                F2 = F2 - torch.bmm(L21 * d.reshape(B * kq, 1, wq),
                                    L21.transpose(1, 2))
                if lv.w_dst.numel():
                    vals.index_copy_(1, nnzK + lv.w_dst,
                                     F2.reshape(B, -1).index_select(
                                         1, lv.w_src))
        fronts_out.append(panels)

    ok = ok & torch.isfinite(Dinv[:, :N]).all(dim=1)
    return {"fronts": fronts_out, "Dinv": Dinv}, ok


def solve(plan: NumericPlan, fac, b, maps: DeviceMaps):
    """Solve K x = b with the factored fronts; b (B, R, N) in ORIGINAL
    order, in the factor dtype -> x (B, R, N).  Forward and backward
    substitution walk the levels; per level a wq-step substitution on
    the (kq, wq) diagonal blocks plus one batched product for all
    trailing-row updates."""
    N = plan.N
    B, R, _ = b.shape
    x = torch.cat([b.index_select(2, maps.perm), b.new_zeros(B, R, 1)],
                  dim=2)

    # forward: (L + I) y = b, leaves -> roots
    for (gp, levels), F_all in zip(maps.groups, fac["fronts"]):
        wq = gp.wq
        for li, lv in enumerate(levels):
            F = F_all[:, li][:, None]                    # (B, 1, kq, fq, wq)
            g = lv.gidx
            x1 = x[:, :, g[:, :wq]]                      # (B, R, kq, wq)
            for j in range(wq - 1):
                x1[..., j + 1:].addcmul_(F[:, :, :, j + 1:wq, j],
                                         x1[..., j:j + 1], value=-1.0)
            x.index_copy_(2, lv.col_gid,
                          x1.reshape(B, R, -1).index_select(2, lv.col_pos))
            if gp.rq and lv.t_pos.numel():
                delta = -(F[:, :, :, wq:, :] * x1[:, :, :, None, :]).sum(
                    dim=4)                               # (B, R, kq, rq)
                lv.t_scatter.add_(
                    x.view(B * R, N + 1),
                    delta.reshape(B * R, -1).index_select(1, lv.t_pos))

    x = x * fac["Dinv"][:, None, :]

    # backward: (L + I)' x = y, roots -> leaves
    for (gp, levels), F_all in reversed(list(zip(maps.groups,
                                                 fac["fronts"]))):
        wq = gp.wq
        for li in range(gp.nl - 1, -1, -1):
            lv = levels[li]
            F = F_all[:, li][:, None]
            g = lv.gidx
            x1 = x[:, :, g[:, :wq]]
            if gp.rq:
                x2 = x[:, :, g[:, wq:]]                  # (B, R, kq, rq)
                x1 = x1 - (F[:, :, :, wq:, :] * x2[..., None]).sum(dim=3)
            # (I + L11)' x1 = x1 column by column from the right: once
            # x1[r] is final, its row of L11 leaves the rows above it
            for r in range(wq - 1, 0, -1):
                x1[..., :r].addcmul_(F[:, :, :, r, :r], x1[..., r:r + 1],
                                     value=-1.0)
            x.index_copy_(2, lv.col_gid,
                          x1.reshape(B, R, -1).index_select(2, lv.col_pos))

    return x[:, :, :N].index_select(2, maps.iperm)


# ---------------------------------------------------------------------
# convenience wrapper mirroring native.LDLFactor for tests
# ---------------------------------------------------------------------

class SparseDeviceLDL:
    """Symbolic-once / refactor-many sparse LDL^T on the device.

    Input: upper-triangular CSC (Ap, Ai) pattern with quasidefinite
    dsigns; `refactor(Ax)` then `solve(b)`.  Ax (nnz,) or (B, nnz) and b
    (N,) or (B, N): a leading batch of problems over the one pattern.
    Runs on `device` (CUDA unless the caller passes device="cpu")."""

    def __init__(self, N, Ap, Ai, dsigns, reg_enable=True, eps=1e-13,
                 delta=2e-7, order=None, max_width: int = 32,
                 relax: int = 8, device=None, dtype=torch.float64):
        self.N = int(N)
        self.device = resolve_device(device)
        self.dtype = dtype
        Ap = np.asarray(Ap, dtype=np.int64)
        Ai = np.asarray(Ai, dtype=np.int64)
        sym = analyze(self.N, Ap, Ai, order=order, relax=relax)
        sym = _split_wide_supernodes(sym, max_width)
        self.sym = sym
        self.plan = build_numeric_plan(sym, np.asarray(dsigns))
        self._kmap = torch.as_tensor(_value_permutation(self.N, Ap, Ai, sym),
                                     device=self.device)
        self.reg = (bool(reg_enable), float(eps), float(delta))
        self.maps = DeviceMaps(self.plan, self.device, dtype)
        self._fac = None

    def refactor(self, Ax):
        """Factor; returns ok (a bool for one problem, else (B,) bools)."""
        Ax = torch.as_tensor(np.asarray(Ax, dtype=np.float64),
                             device=self.device)
        one = Ax.dim() == 1
        Kv = Ax.reshape(-1, Ax.shape[-1]).index_select(1, self._kmap)
        rb, ee, dd = self.reg
        self._fac, ok = factor(self.plan, Kv.to(self.dtype), self.maps,
                               reg_enable=rb, eps=ee, delta=dd)
        ok = ok.cpu().numpy()
        return bool(ok[0]) if one else ok

    def solve(self, b):
        b = torch.as_tensor(np.asarray(b, dtype=np.float64),
                            device=self.device)
        one = b.dim() == 1
        x = solve(self.plan, self._fac,
                  b.reshape(-1, 1, self.N).to(self.dtype), self.maps)
        x = x[:, 0].double().cpu().numpy()
        return x[0] if one else x


def _split_wide_supernodes(sym: SymbolicPlan, max_width: int):
    """Split supernodes wider than max_width into chained panels so the
    unrolled elimination stays bounded.  A panel's rows = remaining
    panel columns + the original rows; its parent is the next panel."""
    new_starts = [0]
    for s in range(sym.ns):
        c0, c1 = int(sym.sn_starts[s]), int(sym.sn_starts[s + 1])
        c = c0
        while c1 - c > max_width:
            c += max_width
            new_starts.append(c)
        new_starts.append(c1)
    new_starts = np.asarray(sorted(set(new_starts)), dtype=np.int64)
    if new_starts.shape[0] == sym.sn_starts.shape[0]:
        return sym

    ns = new_starts.shape[0] - 1
    old_of = np.zeros(ns, dtype=np.int64)
    for t in range(ns):
        old_of[t] = np.searchsorted(sym.sn_starts, new_starts[t],
                                    side="right") - 1
    sn_rows: List[np.ndarray] = []
    for t in range(ns):
        s = int(old_of[t])
        c1_new = int(new_starts[t + 1])
        c1_old = int(sym.sn_starts[s + 1])
        extra = np.arange(c1_new, c1_old, dtype=np.int64)
        sn_rows.append(np.concatenate([extra, sym.sn_rows[s]]))

    sn_parent = np.full(ns, -1, dtype=np.int64)
    col2sn = np.zeros(sym.N, dtype=np.int64)
    for t in range(ns):
        col2sn[new_starts[t]: new_starts[t + 1]] = t
    for t in range(ns):
        if sn_rows[t].shape[0]:
            sn_parent[t] = col2sn[sn_rows[t][0]]

    children: List[List[int]] = [[] for _ in range(ns)]
    for t in range(ns):
        if sn_parent[t] != -1:
            children[sn_parent[t]].append(t)
    level = np.zeros(ns, dtype=np.int64)
    for t in range(ns):
        if children[t]:
            level[t] = 1 + max(level[c] for c in children[t])
    nlev = int(level.max()) + 1 if ns else 0
    levels = [np.nonzero(level == l)[0].astype(np.int64)
              for l in range(nlev)]

    return SymbolicPlan(
        N=sym.N, perm=sym.perm, iperm=sym.iperm, sn_starts=new_starts,
        sn_rows=sn_rows, sn_level=level, sn_parent=sn_parent,
        levels=levels, Ap=sym.Ap, Ai=sym.Ai,
    )


def _value_permutation(N, Ap, Ai, sym: SymbolicPlan):
    """Map original upper-CSC value slots to the permuted pattern's
    slots: kmap[t] = original nz index landing at permuted slot t."""
    # original entries -> permuted (i, j) coordinates
    coords = {}
    for j in range(N):
        for p in range(Ap[j], Ap[j + 1]):
            i = int(Ai[p])
            ni, nj = int(sym.iperm[i]), int(sym.iperm[j])
            a, b = (ni, nj) if ni <= nj else (nj, ni)
            coords[(a, b)] = p
    kmap = np.zeros(sym.Ai.shape[0], dtype=np.int64)
    Pp, Pi = sym.Ap, sym.Ai
    for j in range(N):
        for p in range(Pp[j], Pp[j + 1]):
            kmap[p] = coords[(int(Pi[p]), j)]
    return kmap
