"""Host-side graph analysis for chordal decomposition: fill-reducing
ordering, elimination tree, and symbolic factorization.

The reference performs this step with QDLDL's logical factorization +
AMD ordering (find_graph!, src/chordal/chordal_info.jl:221-252).  Here
the aggregate sparsity patterns are small host-side objects (one per
PSD cone), so we use a plain greedy minimum-degree ordering and a
classic row-subtree symbolic Cholesky — one-time setup work, quality
equivalent for the clique analysis that follows.

A copy of `cuclarabel_tpu/chordal/graph.py` (numpy only).  As in the
reference, `find_graph` takes the filled pattern from the C++ LDL^T of
`native/` (`_native_symbolic`); the row-subtree fill (`etree` +
`symbolic_cholesky`), which gives the same pattern, serves where that
numeric factor fails.  The native library is built on first use, and a
failed build raises.
"""

from typing import List, Tuple

import numpy as np

NO_PARENT = -1


def min_degree_ordering(adj: np.ndarray) -> np.ndarray:
    """Greedy minimum-degree ordering of a symmetric adjacency pattern
    (bool (n,n), diagonal ignored).  Returns perm with perm[k] = vertex
    eliminated at step k (the AMD-equivalent role of QDLDL's ordering,
    directldl_qdldl.jl:10-25)."""
    n = adj.shape[0]
    G = adj.copy()
    np.fill_diagonal(G, False)
    alive = np.ones(n, dtype=bool)
    perm = np.zeros(n, dtype=np.int64)
    for k in range(n):
        deg = np.where(alive, G[:, alive].sum(axis=1), n + 1)
        v = int(np.argmin(deg))
        perm[k] = v
        nb = np.nonzero(G[v] & alive)[0]
        # eliminate v: make its alive neighborhood a clique
        for i in nb:
            G[i, nb] = True
            G[i, i] = False
        G[v, :] = False
        G[:, v] = False
        alive[v] = False
    return perm


def etree(pattern_u: np.ndarray) -> np.ndarray:
    """Elimination tree of a symmetric matrix given its (strict or
    full) upper-triangular pattern (Liu's algorithm)."""
    n = pattern_u.shape[0]
    parent = np.full(n, NO_PARENT, dtype=np.int64)
    ancestor = np.full(n, NO_PARENT, dtype=np.int64)
    for j in range(n):
        for i in np.nonzero(pattern_u[:, j])[0]:
            if i >= j:
                continue
            r = int(i)
            while ancestor[r] != NO_PARENT and ancestor[r] != j:
                nxt = ancestor[r]
                ancestor[r] = j
                r = int(nxt)
            if ancestor[r] == NO_PARENT:
                ancestor[r] = j
                parent[r] = j
    return parent


def symbolic_cholesky(pattern_u: np.ndarray, parent: np.ndarray):
    """Column patterns of the Cholesky factor L (below-diagonal rows of
    each column), via row subtrees.  Returns list of sorted index lists."""
    n = pattern_u.shape[0]
    cols: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        marked = {i}
        for j in np.nonzero(pattern_u[:, i])[0]:
            if j >= i:
                continue
            r = int(j)
            while r not in marked and r < i:
                cols[r].append(i)
                marked.add(r)
                r = int(parent[r]) if parent[r] != NO_PARENT else i
    return [sorted(set(c)) for c in cols]


def connect_graph(cols: List[List[int]]) -> None:
    """Fix a disconnected filled graph: a column j < n-1 with no
    below-diagonal entry gets L[j+1, j] = 1 (connect_graph!,
    chordal_info.jl:255-279)."""
    n = len(cols)
    for j in range(n - 1):
        if not any(r > j for r in cols[j]):
            cols[j] = sorted(set(cols[j]) | {j + 1})


def _native_symbolic(pat_u: np.ndarray):
    """Filled-pattern column lists via the native C++ LDL kernel
    (a diagonally dominant numeric factor on the pattern yields exactly
    the symbolic fill).  Returns None if the numeric factor fails."""
    from ..native import LDLFactor

    n = pat_u.shape[0]
    Ap = [0]
    Ai, Ax = [], []
    for j in range(n):
        for i in range(j + 1):
            if pat_u[i, j] or i == j:
                Ai.append(i)
                Ax.append(float(n + 1) if i == j else 1.0)
        Ap.append(len(Ai))
    fac = LDLFactor(
        n, np.asarray(Ap), np.asarray(Ai),
        np.ones(n, dtype=np.int64), reg_enable=False,
    )
    if not fac.refactor(np.asarray(Ax)):
        return None
    return [
        sorted(int(r) for r in fac.Li[fac.Lp[j]: fac.Lp[j + 1]])
        for j in range(n)
    ]


def find_graph(nz_mask: np.ndarray, nv: int) -> Tuple[List[List[int]], np.ndarray]:
    """From the svec aggregate-sparsity mask of one PSD cone, compute
    (L column patterns, ordering) of the permuted filled graph
    (find_graph!, chordal_info.jl:221-252).  ordering[k] = original
    vertex at permuted position k."""
    # mask -> (nv, nv) pattern (svec upper triangle, column-major)
    pat = np.zeros((nv, nv), dtype=bool)
    a = 0
    for j in range(nv):
        for i in range(j + 1):
            if nz_mask[a]:
                pat[i, j] = True
                pat[j, i] = True
            a += 1
    np.fill_diagonal(pat, True)

    perm = min_degree_ordering(pat)
    pat_p = pat[np.ix_(perm, perm)]
    pat_u = np.triu(pat_p)

    cols = _native_symbolic(pat_u)
    if cols is None:
        cols = symbolic_cholesky(pat_u, etree(pat_u))
    connect_graph(cols)
    return cols, perm
