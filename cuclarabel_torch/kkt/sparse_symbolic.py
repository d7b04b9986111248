"""Host-side symbolic analysis for the device sparse KKT backend.

The reference's sparse path is QDLDL through per-column elimination
(`directldl_qdldl.jl:10-96`) — scalar, scatter-heavy, and hostile to
TPUs.  The TPU-native design is a **level-scheduled supernodal
multifrontal** factorization: the host computes (once per sparsity
pattern) a fill-reducing ordering, the elimination tree, a supernode
partition, and a level schedule in which all supernodes of one level
are independent; the device then factors each level as ONE batched
dense partial-LDL^T of padded frontal matrices (MXU/VPU work), with
extend-add scatter maps precomputed here as flat index arrays.

Everything in this module is numpy; the output `SymbolicPlan` contains
only static metadata for the numeric phase (kkt/sparse_device.py).

A copy of `cuclarabel_tpu/kkt/sparse_symbolic.py`.  Its minimum-degree
ordering comes from the port's own `native/` package, and where the
reference falls back to the natural order without that library, this
copy raises (the library is built on first use, and a failed build
raises).
"""

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------
# elimination tree / column counts (upper CSC pattern)
# ---------------------------------------------------------------------

def etree_colcounts(N: int, Ap: np.ndarray, Ai: np.ndarray):
    """Liu's elimination tree + nnz per column of L (strict lower).
    Same math as native/ldl.cpp:ldl_analyze, here in numpy for
    host-side planning."""
    parent = np.full(N, -1, dtype=np.int64)
    mark = np.full(N, -1, dtype=np.int64)
    colcount = np.zeros(N, dtype=np.int64)
    for k in range(N):
        mark[k] = k
        for p in range(Ap[k], Ap[k + 1]):
            j = Ai[p]
            if j > k:
                raise ValueError("pattern must be upper triangular")
            while mark[j] != k:
                mark[j] = k
                colcount[j] += 1
                if parent[j] == -1:
                    parent[j] = k
                j = parent[j]
    return parent, colcount


def row_patterns(N: int, Ap: np.ndarray, Ai: np.ndarray,
                 parent: np.ndarray) -> List[List[int]]:
    """Column patterns of L (per column, sorted ascending rows)."""
    cols: List[List[int]] = [[] for _ in range(N)]
    mark = np.full(N, -1, dtype=np.int64)
    for k in range(N):
        mark[k] = k
        for p in range(Ap[k], Ap[k + 1]):
            j = Ai[p]
            while mark[j] != k:
                mark[j] = k
                cols[j].append(k)
                j = parent[j]
    return cols  # already ascending since k grows


# ---------------------------------------------------------------------
# supernodes
# ---------------------------------------------------------------------

def find_supernodes(parent: np.ndarray, colcount: np.ndarray,
                    relax: int = 8):
    """Fundamental supernodes: consecutive columns merge when
    parent(j) = j+1, j+1 has no other etree child, and the structures
    nest exactly (colcount[j] = colcount[j+1] + 1).  Relaxation happens
    afterwards on the supernodal tree (`amalgamate`), not here — the
    strict nchild==1 condition fails on nearly every separator column
    of a dissection ordering (subdomain updates attach extra children),
    which left every supernode width-1 before relaxed amalgamation
    existed.  Returns snode start indices (ns+1,) and a col->snode map.
    `relax` is accepted for signature stability; exact nesting only."""
    del relax
    N = parent.shape[0]
    nchild = np.zeros(N, dtype=np.int64)
    for j in range(N):
        if parent[j] != -1:
            nchild[parent[j]] += 1
    starts = [0]
    for j in range(1, N):
        prev = j - 1
        mergeable = (
            parent[prev] == j
            and nchild[j] == 1
            and colcount[prev] == colcount[j] + 1
        )
        if not mergeable:
            starts.append(j)
    starts.append(N)
    starts = np.asarray(starts, dtype=np.int64)
    col2sn = np.zeros(N, dtype=np.int64)
    for s in range(len(starts) - 1):
        col2sn[starts[s]: starts[s + 1]] = s
    return starts, col2sn


def amalgamate(N: int, sn_starts: np.ndarray, cols: List[List[int]],
               relax: int = 8, max_pad_frac: float = 0.25,
               small: int = 16):
    """Relaxed supernode amalgamation (CHOLMOD-style) on the supernodal
    assembly tree.  A child supernode merges into its parent when its
    columns immediately precede the parent's (contiguity keeps the
    assembly-tree containment property: the merged node's rows are the
    union minus its own columns) and the merge stays cheap: both sides
    small (<= `small` columns), or the explicit-zero padding introduced
    in the merged front is <= `max_pad_frac` of its lower triangle, or
    the row-structure mismatch is <= `relax` rows.  This is what turns
    the width-1 chains a dissection ordering produces on separators
    into wide MXU-friendly panels — without it the level schedule of a
    100x100 grid KKT was 484 levels deep with wmax=1 everywhere.

    cols: per-column strict-lower L patterns (row_patterns output).
    Returns new sn_starts."""
    starts = [int(s) for s in sn_starts[:-1]]
    ends = [int(s) for s in sn_starts[1:]]
    ns = len(starts)
    # per-snode row structure (below own columns) and nnz bookkeeping
    rows: List[set] = []
    width = []
    nzero = []  # explicit zeros already committed by earlier merges
    for s in range(ns):
        c0, c1 = starts[s], ends[s]
        r = set()
        for j in range(c0, c1):
            r.update(x for x in cols[j] if x >= c1)
        rows.append(r)
        width.append(c1 - c0)
        nzero.append(_snode_pad(c0, c1, r, cols))
    parent_of = list(range(ns))  # union-find over merged snodes

    def find(s):
        while parent_of[s] != s:
            parent_of[s] = parent_of[parent_of[s]]
            s = parent_of[s]
        return s

    col2sn = np.zeros(N, dtype=np.int64)
    for s in range(ns):
        col2sn[starts[s]: ends[s]] = s

    # walk children in reverse column order so chains collapse bottom-up
    for s in range(ns - 2, -1, -1):
        c = find(s)
        r = rows[c]
        if not r:
            continue
        p = find(int(col2sn[min(r)]))
        if p == c or starts[p] != ends[c]:
            continue  # not the immediately following snode
        wc, wp = width[c], width[p]
        merged_rows = (r | rows[p]) - set(range(ends[c], ends[p]))
        w = wc + wp
        f = w + len(merged_rows)
        # nnz of the merged lower-triangular panel vs the true nnz
        tri = w * (w + 1) // 2 + w * len(merged_rows)
        true_nnz = (
            wc * (wc + 1) // 2 + wc * len(r)
            + wp * (wp + 1) // 2 + wp * len(rows[p])
            - nzero[c] - nzero[p]
        )
        pad = tri - true_nnz
        ok = (
            (wc <= small and wp <= small)
            or pad <= relax * w
            or (tri > 0 and pad / tri <= max_pad_frac)
        )
        if not ok:
            continue
        parent_of[c] = p
        starts[p] = starts[c]
        width[p] = w
        rows[p] = merged_rows
        nzero[p] = pad

    new_starts = sorted({starts[find(s)] for s in range(ns)} | {N})
    return np.asarray(new_starts, dtype=np.int64)


def _snode_pad(c0: int, c1: int, rows: set, cols: List[List[int]]) -> int:
    """Explicit zeros in a supernode panel: slots of the (c1-c0)-wide
    lower panel not present in the member columns' true patterns."""
    w = c1 - c0
    tri = w * (w + 1) // 2 + w * len(rows)
    true_nnz = 0
    for j in range(c0, c1):
        true_nnz += 1 + sum(1 for x in cols[j] if x > j)
    return tri - true_nnz


@dataclasses.dataclass
class SymbolicPlan:
    """Static plan for the device numeric phase."""

    N: int
    perm: np.ndarray           # fill-reducing ordering (new <- old)
    iperm: np.ndarray
    sn_starts: np.ndarray      # (ns+1,) supernode column ranges
    sn_rows: List[np.ndarray]  # per snode: below-diagonal row indices
    sn_level: np.ndarray       # (ns,) level in the supernodal etree
    sn_parent: np.ndarray      # (ns,)
    levels: List[np.ndarray]   # snode ids per level (leaves first)
    # per-snode static maps (built lazily by the numeric backend)
    Ap: np.ndarray
    Ai: np.ndarray

    @property
    def ns(self) -> int:
        return self.sn_starts.shape[0] - 1

    def front_width(self, s: int) -> int:
        return int(self.sn_starts[s + 1] - self.sn_starts[s])

    def front_size(self, s: int) -> int:
        return self.front_width(s) + len(self.sn_rows[s])


def analyze(N: int, Ap: np.ndarray, Ai: np.ndarray,
            order: Optional[np.ndarray] = None,
            relax: int = 8) -> SymbolicPlan:
    """Full symbolic analysis of an upper-CSC pattern.

    order: optional fill-reducing permutation (new <- old); when None a
    minimum-degree ordering is computed by the native kernel."""
    Ap = np.asarray(Ap, dtype=np.int64)
    Ai = np.asarray(Ai, dtype=np.int64)

    if order is None:
        order = _mindeg(N, Ap, Ai)
    perm = np.asarray(order, dtype=np.int64)
    iperm = np.argsort(perm)

    Pp, Pi = _permute_upper(N, Ap, Ai, perm, iperm)
    parent, colcount = etree_colcounts(N, Pp, Pi)
    cols = row_patterns(N, Pp, Pi, parent)

    sn_starts, col2sn = find_supernodes(parent, colcount, relax)
    if relax:
        sn_starts = amalgamate(N, sn_starts, cols, relax=relax)
        col2sn = np.zeros(N, dtype=np.int64)
        for s in range(sn_starts.shape[0] - 1):
            col2sn[sn_starts[s]: sn_starts[s + 1]] = s
    ns = sn_starts.shape[0] - 1

    # supernode row structure = union of member column structures minus
    # the supernode's own columns = structure of the FIRST column minus
    # member columns (nesting), padded by relaxation unions
    sn_rows: List[np.ndarray] = []
    for s in range(ns):
        c0, c1 = sn_starts[s], sn_starts[s + 1]
        rows = set()
        for j in range(c0, c1):
            rows.update(r for r in cols[j] if r >= c1)
        sn_rows.append(np.asarray(sorted(rows), dtype=np.int64))

    # supernodal etree + levels (leaves first)
    sn_parent = np.full(ns, -1, dtype=np.int64)
    for s in range(ns):
        rows = sn_rows[s]
        if rows.shape[0]:
            sn_parent[s] = col2sn[rows[0]]
    level = np.zeros(ns, dtype=np.int64)
    for s in range(ns - 1, -1, -1):
        p = sn_parent[s]
        if p != -1:
            level[s] = 0  # recompute below
    # height from leaves: level(s) = 1 + max(level(children))
    children: List[List[int]] = [[] for _ in range(ns)]
    for s in range(ns):
        if sn_parent[s] != -1:
            children[sn_parent[s]].append(s)
    for s in range(ns):  # snodes are topologically ordered by column
        if children[s]:
            level[s] = 1 + max(level[c] for c in children[s])
        else:
            level[s] = 0
    nlev = int(level.max()) + 1 if ns else 0
    levels = [np.nonzero(level == l)[0].astype(np.int64)
              for l in range(nlev)]

    return SymbolicPlan(
        N=N, perm=perm, iperm=iperm, sn_starts=sn_starts,
        sn_rows=sn_rows, sn_level=level, sn_parent=sn_parent,
        levels=levels, Ap=Pp, Ai=Pi,
    )


def nested_dissection(N: int, Ap: np.ndarray, Ai: np.ndarray,
                      leaf: int = 48) -> np.ndarray:
    """George-Liu style nested dissection on the symmetrized pattern:
    recursive BFS-level bisection with the middle level as separator,
    ordered [part1, part2, separator].  Short elimination-tree chains
    are what the level-scheduled multifrontal wants (minimum-degree on
    meshes produces O(N)-length chains -> huge level counts); small
    components fall back to minimum degree.  Returns order new->old."""
    # adjacency (both triangles, no diagonal)
    adj: List[List[int]] = [[] for _ in range(N)]
    for j in range(N):
        for p in range(Ap[j], Ap[j + 1]):
            i = int(Ai[p])
            if i != j:
                adj[i].append(j)
                adj[j].append(i)

    out: List[int] = []

    def bfs_layers(nodes_set, start):
        layers = [[start]]
        seen = {start}
        while True:
            nxt = []
            for v in layers[-1]:
                for u in adj[v]:
                    if u in nodes_set and u not in seen:
                        seen.add(u)
                        nxt.append(u)
            if not nxt:
                return layers, seen
            layers.append(nxt)

    def order(nodes: List[int]):
        if len(nodes) <= leaf:
            out.extend(_mindeg_sub(nodes))
            return
        nodes_set = set(nodes)
        # pseudo-peripheral start: two BFS sweeps
        start = nodes[0]
        layers, seen = bfs_layers(nodes_set, start)
        if len(seen) < len(nodes):
            # disconnected: order this component, recurse on the rest
            comp = [v for v in nodes if v in seen]
            rest = [v for v in nodes if v not in seen]
            order(comp)
            order(rest)
            return
        start = layers[-1][0]
        layers, _ = bfs_layers(nodes_set, start)
        if len(layers) < 3:
            out.extend(_mindeg_sub(nodes))
            return
        mid = len(layers) // 2
        sep = layers[mid]
        left = [v for l in layers[:mid] for v in l]
        right = [v for l in layers[mid + 1:] for v in l]
        order(left)
        order(right)
        out.extend(sep)

    def _mindeg_sub(nodes: List[int]):
        # local greedy min-degree within the subgraph
        nodes_set = set(nodes)
        deg = {v: sum(1 for u in adj[v] if u in nodes_set) for v in nodes}
        loc_adj = {v: set(u for u in adj[v] if u in nodes_set)
                   for v in nodes}
        seq = []
        alive = set(nodes)
        while alive:
            v = min(alive, key=lambda x: len(loc_adj[x] & alive))
            seq.append(v)
            alive.discard(v)
            nb = loc_adj[v] & alive
            for u in nb:
                loc_adj[u] |= nb
                loc_adj[u].discard(u)
        return seq

    # strip near-dense vertices to the top separator: a single dense
    # row/column couples everything and collapses BFS layering (every
    # vertex within 2 hops), defeating the dissection
    degs = np.asarray([len(a) for a in adj])
    thresh = max(16, 4 * int(np.sqrt(N)))
    dense_v = [v for v in range(N) if degs[v] > thresh]
    keep = [v for v in range(N) if degs[v] <= thresh]
    dense_set = set(dense_v)
    if dense_v:
        adj = [[u for u in a if u not in dense_set] for a in adj]

    import sys
    rec = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec, 10000))
    try:
        order(keep)
    finally:
        sys.setrecursionlimit(rec)
    out.extend(dense_v)
    return np.asarray(out, dtype=np.int64)


def _mindeg(N, Ap, Ai):
    """Minimum-degree ordering via the native kernel."""
    from ..native import mindeg_ordering

    # build full (both triangles) pattern for the graph input
    rows = []
    cols_ = []
    for j in range(N):
        for p in range(Ap[j], Ap[j + 1]):
            i = Ai[p]
            if i != j:
                rows.append(i); cols_.append(j)
                rows.append(j); cols_.append(i)
    if not rows:
        return np.arange(N, dtype=np.int64)
    order = np.lexsort((np.asarray(rows), np.asarray(cols_)))
    r = np.asarray(rows)[order]
    c = np.asarray(cols_)[order]
    keep = np.ones(len(r), dtype=bool)
    keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    r, c = r[keep], c[keep]
    Fp = np.zeros(N + 1, dtype=np.int64)
    np.add.at(Fp, c + 1, 1)
    Fp = np.cumsum(Fp)
    return mindeg_ordering(N, Fp, r.astype(np.int64))


def _permute_upper(N, Ap, Ai, perm, iperm):
    """Upper-CSC pattern of P K P' given upper-CSC K.  perm maps
    NEW index -> OLD index; iperm OLD -> NEW."""
    ri, ci = [], []
    for j in range(N):
        nj = iperm[j]
        for p in range(Ap[j], Ap[j + 1]):
            ni = iperm[Ai[p]]
            a, b = (ni, nj) if ni <= nj else (nj, ni)
            ri.append(a)
            ci.append(b)
    ri = np.asarray(ri, dtype=np.int64)
    ci = np.asarray(ci, dtype=np.int64)
    order = np.lexsort((ri, ci))
    ri, ci = ri[order], ci[order]
    keep = np.ones(ri.shape[0], dtype=bool)
    keep[1:] = (ri[1:] != ri[:-1]) | (ci[1:] != ci[:-1])
    ri, ci = ri[keep], ci[keep]
    Pp = np.zeros(N + 1, dtype=np.int64)
    np.add.at(Pp, ci + 1, 1)
    Pp = np.cumsum(Pp)
    return Pp, ri
