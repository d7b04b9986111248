"""Chordal decomposition of PSD cones: analysis, problem augmentation
(compact and standard), reverse transforms, and PSD completion.

A copy of `cuclarabel_tpu/chordal/decomp.py` (numpy only; the port
imports nothing of the JAX package).

Behavioral parity with `src/chordal/chordal_info.jl` and
`src/chordal/decomposition/*`:

  * analysis: aggregate sparsity of [A; b] rows per PSD cone, forced
    diagonal, symbolic factorization -> SuperNodeTree -> clique merge;
  * compact ("rangespace", Kim et al. 2011) transform: each clique
    becomes its own PSDTriangleConeT; separator entries of non-root
    cliques turn into overlap columns of A with (+1, -1) coupling to
    the parent clique (augment_compact.jl:9-97);
  * standard (COSMO-style) transform: A <- [A H; 0 -I] with a ZeroCone
    over the original rows and clique cones below
    (augment_standard.jl:5-135);
  * reverse: reassemble (s, z) from cliques — accumulation for compact
    (reverse_compact.jl), H-products with overlap averaging for
    standard (reverse_standard.jl);
  * PSD completion of the dual variable via clique-tree traversal
    (Vandenberghe's chordal-graphs algorithm, psd_completion.jl:9-106).

The problem matrices here are dense (matching the dense KKT backend),
which collapses the reference's CSC index bookkeeping into plain row
gathers and scatters.
"""

from typing import List, Optional, Tuple

import numpy as np

from ..cones import api
from ..cones.api import PSDTriangleConeT, SupportedCone, ZeroConeT
from .graph import find_graph
from .merge import merge_cliques
from .sntree import SuperNodeTree


def _tri(k: int) -> int:
    return k * (k + 1) // 2


def _svec_idx(i: int, j: int) -> int:
    """0-based svec (column-major upper triangle) index of (i <= j)."""
    return j * (j + 1) // 2 + i


class SparsityPattern:
    """SuperNodeTree + vertex ordering for one decomposed PSD cone
    (src/chordal/sparsity_pattern.jl)."""

    def __init__(self, Lcols, ordering, orig_index: int, merge_method: str):
        self.sntree = SuperNodeTree(Lcols)
        if self.sntree.n_cliques > 1:
            merge_cliques(merge_method, self.sntree)
        self.ordering = self.sntree.reorder_snode_consecutively(ordering)
        self.sntree.calculate_block_dimensions()
        self.orig_index = orig_index


class ChordalInfo:
    """Decomposition analysis of the problem's PSD cones
    (src/chordal/chordal_info.jl)."""

    def __init__(self, A: np.ndarray, b: np.ndarray, cones, settings):
        self.init_dims = (A.shape[1], A.shape[0])
        self.init_cones: List[SupportedCone] = list(cones)
        self.spatterns: List[SparsityPattern] = []
        self.H: Optional[np.ndarray] = None
        self.cone_maps = None

        nz_mask = (np.abs(A).sum(axis=1) != 0) | (b != 0)

        ofs = 0
        for coneidx, cone in enumerate(cones):
            d = api.nvars(cone)
            if isinstance(cone, PSDTriangleConeT) and cone.dim > 1:
                mask = nz_mask[ofs : ofs + d].copy()
                # force diagonal (analyse_psdtriangle_sparsity_pattern!)
                for k in range(cone.dim):
                    mask[_tri(k + 1) - 1] = True
                if not mask.all():
                    Lcols, ordering = find_graph(mask, cone.dim)
                    sp = SparsityPattern(
                        Lcols, ordering, coneidx,
                        settings.chordal_decomposition_merge_method,
                    )
                    if sp.sntree.n_cliques > 1:
                        self.spatterns.append(sp)
            ofs += d

    def is_decomposed(self) -> bool:
        return len(self.spatterns) > 0

    def _pattern_for(self, coneidx: int) -> Optional[SparsityPattern]:
        for sp in self.spatterns:
            if sp.orig_index == coneidx:
                return sp
        return None


def _cone_ranges(cones):
    out = []
    ofs = 0
    for c in cones:
        d = api.nvars(c)
        out.append((ofs, ofs + d))
        ofs += d
    return out


def _clique_entries(sp: SparsityPattern, i: int):
    """Sorted block entries of clique i (post order) in original vertex
    labels: [(vi, vj, is_overlap)] sorted like get_block_indices
    (augment_compact.jl:382-407).  is_overlap = both in separator."""
    t = sp.sntree
    sep = sorted(int(sp.ordering[v]) for v in t.get_separators(i))
    sno = sorted(int(sp.ordering[v]) for v in t.get_snode(i))
    sepset = set(sep)
    entries = []
    clique = sorted(sep + sno)
    for j in clique:
        for i_ in clique:
            if i_ <= j:
                entries.append((i_, j, i_ in sepset and j in sepset))
    return entries


# ---------------------------------------------------------------------------
# compact (rangespace) augmentation
# ---------------------------------------------------------------------------


def _augment_compact(info: ChordalInfo, P, q, A, b):
    n = A.shape[1]
    ranges = _cone_ranges(info.init_cones)

    # sizes
    total_rows = 0
    n_overlaps = 0
    for coneidx, cone in enumerate(info.init_cones):
        sp = info._pattern_for(coneidx)
        if sp is None:
            total_rows += api.nvars(cone)
        else:
            dim, ovl = sp.sntree.get_decomposed_dim_and_overlaps()
            total_rows += dim
            n_overlaps += ovl

    A_new = np.zeros((total_rows, n + n_overlaps))
    b_new = np.zeros(total_rows)
    cones_new: List[SupportedCone] = []
    cone_maps = []  # (orig_index, None | (pattern_idx, clique_idx))

    row_ptr = 0
    ovl_ptr = n
    for coneidx, cone in enumerate(info.init_cones):
        lo, hi = ranges[coneidx]
        sp = info._pattern_for(coneidx)
        if sp is None:
            d = hi - lo
            A_new[row_ptr : row_ptr + d, :n] = A[lo:hi]
            b_new[row_ptr : row_ptr + d] = b[lo:hi]
            cones_new.append(cone)
            cone_maps.append((coneidx, None))
            row_ptr += d
            continue

        t = sp.sntree
        pat_idx = info.spatterns.index(sp)

        # row ranges per clique, assigned in descending topological
        # order (clique_rows_map, augment_compact.jl:412-430)
        clique_row_start = {}
        rp = row_ptr
        for i in range(t.n_cliques - 1, -1, -1):
            clique_row_start[i] = rp
            rp += _tri(t.get_nblk(i))

        for i in range(t.n_cliques - 1, -1, -1):
            entries = _clique_entries(sp, i)
            r0 = clique_row_start[i]
            if i < t.n_cliques - 1:
                # parent clique in post order: find post index of parent
                p_node = t.get_clique_parent(i)
                p_post = t.snode_post.index(p_node)
                parent_clique = sorted(
                    int(sp.ordering[v]) for v in t.get_clique_by_index(p_node)
                )
                parent_r0 = clique_row_start[p_post]
            for a, (vi, vj, is_ovl) in enumerate(entries):
                row = r0 + a
                if is_ovl:
                    # overlap: +1 here, -1 at the parent's copy
                    pi = parent_clique.index(vi)
                    pj = parent_clique.index(vj)
                    A_new[row, ovl_ptr] = 1.0
                    A_new[parent_r0 + _svec_idx(pi, pj), ovl_ptr] = -1.0
                    ovl_ptr += 1
                else:
                    k = lo + _svec_idx(vi, vj)
                    A_new[row, :n] = A[k]
                    b_new[row] = b[k]
            cones_new.append(PSDTriangleConeT(t.get_nblk(i)))
            cone_maps.append((coneidx, (pat_idx, i)))
        row_ptr = rp

    info.cone_maps = cone_maps
    nadd = n_overlaps
    P_new = np.zeros((n + nadd, n + nadd))
    P_new[:n, :n] = P
    q_new = np.concatenate([q, np.zeros(nadd)])
    return P_new, q_new, A_new, b_new, cones_new


# ---------------------------------------------------------------------------
# standard (COSMO-style) augmentation
# ---------------------------------------------------------------------------


def _augment_standard(info: ChordalInfo, P, q, A, b):
    n = A.shape[1]
    m = A.shape[0]
    ranges = _cone_ranges(info.init_cones)

    cones_new: List[SupportedCone] = [ZeroConeT(m)]
    H_cols = []  # original row index of each H column

    for coneidx, cone in enumerate(info.init_cones):
        lo, _ = ranges[coneidx]
        sp = info._pattern_for(coneidx)
        if sp is None:
            H_cols.extend(range(lo, lo + api.nvars(cone)))
            cones_new.append(cone)
        else:
            t = sp.sntree
            for i in range(t.n_cliques):
                clique = sorted(
                    int(sp.ordering[v]) for v in t.get_clique(i)
                )
                for jj in range(len(clique)):
                    for ii in range(jj + 1):
                        H_cols.append(
                            lo + _svec_idx(clique[ii], clique[jj])
                        )
                cones_new.append(PSDTriangleConeT(t.get_nblk(i)))

    nH = len(H_cols)
    H = np.zeros((m, nH))
    H[np.asarray(H_cols), np.arange(nH)] = 1.0
    info.H = H

    A_new = np.block(
        [[A, H], [np.zeros((nH, n)), -np.eye(nH)]]
    )
    b_new = np.concatenate([b, np.zeros(nH)])
    P_new = np.zeros((n + nH, n + nH))
    P_new[:n, :n] = P
    q_new = np.concatenate([q, np.zeros(nH)])
    return P_new, q_new, A_new, b_new, cones_new


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def decomp_augment(info: ChordalInfo, P, q, A, b, settings):
    """decomp_augment! (decomposition/decomp.jl:1-16)."""
    if settings.chordal_decomposition_compact:
        return _augment_compact(info, P, q, A, b)
    return _augment_standard(info, P, q, A, b)


def decomp_reverse(info: ChordalInfo, x, s, z, settings):
    """Reassemble (x, s, z) of the original problem from the decomposed
    solution (decomp_reverse!, decomposition/decomp.jl:22-60)."""
    n, m = info.init_dims
    x_new = x[:n]
    s_new = np.zeros(m)
    z_new = np.zeros(m)

    if settings.chordal_decomposition_compact:
        _reverse_compact(info, s_new, z_new, s, z)
    else:
        _reverse_standard(info, s_new, z_new, s, z)

    if settings.chordal_decomposition_complete_dual:
        _psd_completion(info, z_new)
    return x_new, s_new, z_new


def _reverse_compact(info, new_s, new_z, old_s, old_z):
    """reverse_compact.jl: accumulate s over cliques; z overwrites."""
    ranges = _cone_ranges(info.init_cones)
    row_ptr = 0
    for orig_index, tree_clique in info.cone_maps:
        lo, hi = ranges[orig_index]
        if tree_clique is None:
            d = hi - lo
            new_s[lo:hi] = old_s[row_ptr : row_ptr + d]
            new_z[lo:hi] = old_z[row_ptr : row_ptr + d]
            row_ptr += d
            continue
        pat_idx, clique_idx = tree_clique
        sp = info.spatterns[pat_idx]
        clique = sorted(
            int(sp.ordering[v]) for v in sp.sntree.get_clique(clique_idx)
        )
        a = 0
        for j in clique:
            for i in clique:
                if i <= j:
                    k = lo + _svec_idx(i, j)
                    new_s[k] += old_s[row_ptr + a]
                    new_z[k] = old_z[row_ptr + a]
                    a += 1
        row_ptr += _tri(len(clique))


def _reverse_standard(info, new_s, new_z, old_s, old_z):
    """reverse_standard.jl: s,z = H * tail; average z overlaps."""
    H = info.H
    m = H.shape[0]
    new_s[:] = H @ old_s[m:]
    new_z[:] = H @ old_z[m:]
    counts = H.sum(axis=1)
    overlap = counts > 1
    new_z[overlap] /= counts[overlap]


def _psd_completion(info: ChordalInfo, z: np.ndarray):
    """Complete dual PSD blocks via the clique tree (psd_complete!,
    psd_completion.jl:43-105)."""
    ranges = _cone_ranges(info.init_cones)
    for sp in info.spatterns:
        lo, hi = ranges[sp.orig_index]
        zblk = z[lo:hi]
        nv = info.init_cones[sp.orig_index].dim
        Z = _svec_to_mat(zblk, nv)
        _complete_mat(Z, sp)
        z[lo:hi] = _mat_to_svec(Z, nv)


def _svec_to_mat(v, nv):
    M = np.zeros((nv, nv))
    a = 0
    isq2 = 1.0 / np.sqrt(2.0)
    for j in range(nv):
        for i in range(j + 1):
            M[i, j] = M[j, i] = v[a] if i == j else v[a] * isq2
            a += 1
    return M


def _mat_to_svec(M, nv):
    v = np.zeros(_tri(nv))
    a = 0
    sq2 = np.sqrt(2.0)
    for j in range(nv):
        for i in range(j + 1):
            v[a] = M[i, i] if i == j else M[i, j] * sq2
            a += 1
    return v


def _complete_mat(A: np.ndarray, sp: SparsityPattern):
    t = sp.sntree
    p = np.asarray(sp.ordering)
    ip = np.argsort(p)
    N = A.shape[0]
    W = A[np.ix_(p, p)]

    for j in range(t.n_cliques - 2, -1, -1):
        nu = sorted(t.get_snode(j))
        alpha = sorted(t.get_separators(j))
        i0 = nu[0]
        excl = set(alpha) | set(nu)
        eta = [k for k in range(i0 + 1, N) if k not in excl]
        if not alpha or not eta:
            continue
        Waa = W[np.ix_(alpha, alpha)]
        Wan = W[np.ix_(alpha, nu)]
        try:
            Y = np.linalg.solve(Waa, Wan)
        except np.linalg.LinAlgError:
            Y = np.linalg.pinv(Waa) @ Wan
        W[np.ix_(eta, nu)] = W[np.ix_(eta, alpha)] @ Y
        W[np.ix_(nu, eta)] = W[np.ix_(eta, nu)].T

    A[:, :] = W[np.ix_(ip, ip)]
