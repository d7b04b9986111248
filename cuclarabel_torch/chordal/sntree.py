"""Supernodal elimination tree analysis of a symbolic factor L.

A copy of `cuclarabel_tpu/chordal/sntree.py` (numpy only; the port
imports nothing of the JAX package).

Behavioral parity with `src/chordal/supernode_tree.jl`: elimination-tree
parents, postordering, Pothen-Sun supernode partition, separators,
consecutive reordering (required for PSD completion), and clique block
dimensions.  All host-side; vertex sets are Python sets / sorted lists.
"""

from typing import List, Set

import numpy as np

NO_PARENT = -1
INACTIVE = -2


def children_from_parent(parent: List[int]) -> List[Set[int]]:
    children: List[Set[int]] = [set() for _ in parent]
    for i, p in enumerate(parent):
        if p not in (NO_PARENT, INACTIVE):
            children[p].add(i)
    return children


def post_order(parent: List[int], children: List[Set[int]], nc: int) -> List[int]:
    """Topological postorder by DFS from the root; returns the nc
    active vertices in post order (post_order!,
    supernode_tree.jl:248-280)."""
    n = len(parent)
    order = [nc + 1] * n
    root = next(i for i, p in enumerate(parent) if p == NO_PARENT)
    stack = [root]
    i = nc - 1
    while stack:
        v = stack.pop()
        order[v] = i
        i -= 1
        stack.extend(sorted(children[v]))
    post = sorted(range(n), key=lambda x: order[x])
    return post[:nc]


def _pothen_sun(parent, post, degree):
    """Supernode partition (Pothen & Sun 1989; pothen_sun,
    supernode_tree.jl:301-370).  Returns (snode_parent over
    representative vertices, snode_index)."""
    n = len(parent)
    snode_index = [-1] * n  # < 0: representative; >= 0: member of that rep
    snode_parent = [NO_PARENT] * n
    children: List[Set[int]] = [set() for _ in range(n)]
    root_index = next(i for i, p in enumerate(parent) if p == NO_PARENT)

    for v in post:
        if parent[v] == NO_PARENT:
            children[root_index].add(v)
        else:
            children[parent[v]].add(v)

        if parent[v] != NO_PARENT:
            if degree[v] - 1 == degree[parent[v]] and snode_index[parent[v]] == -1:
                if snode_index[v] < 0:
                    snode_index[parent[v]] = v
                    snode_index[v] -= 1
                else:
                    snode_index[parent[v]] = snode_index[v]
                    snode_index[snode_index[v]] -= 1
            else:
                if snode_index[v] < 0:
                    snode_parent[v] = v
                else:
                    snode_parent[snode_index[v]] = snode_index[v]

        k = v if snode_index[v] < 0 else snode_index[v]
        for w in children[v]:
            l = w if snode_index[w] < 0 else snode_index[w]
            if l != k:
                snode_parent[l] = k

    repr_vertex = [i for i, f in enumerate(snode_index) if f < 0]
    repr_pos = {r: i for i, r in enumerate(repr_vertex)}
    sp = []
    for r in repr_vertex:
        rp = snode_parent[r]
        sp.append(repr_pos.get(rp, NO_PARENT))
    return sp, snode_index


class SuperNodeTree:
    """Supernode partition + separators of a filled graph given by the
    below-diagonal column patterns `Lcols` (SuperNodeTree ctor,
    supernode_tree.jl:33-64)."""

    def __init__(self, Lcols: List[List[int]]):
        n = len(Lcols)
        parent = [NO_PARENT] * n
        for v in range(n - 1):
            parent[v] = Lcols[v][0]  # first below-diagonal row
        children = children_from_parent(parent)
        self.post = post_order(parent, children, n)

        degree = [len(Lcols[v]) for v in range(n)]
        snode_parent, snode_index = _pothen_sun(parent, self.post, degree)

        repr_vertex = [i for i, f in enumerate(snode_index) if f < 0]
        nsn = len(repr_vertex)
        repr_pos = {r: i for i, r in enumerate(repr_vertex)}
        snode: List[Set[int]] = [set() for _ in range(nsn)]
        for i, f in enumerate(snode_index):
            if f < 0:
                snode[repr_pos[i]].add(i)
            else:
                snode[repr_pos[f]].add(i)

        self.snode = snode
        self.snode_parent = snode_parent
        self.snode_children = children_from_parent(snode_parent)
        self.n_cliques = nsn

        # separators: higher neighbors of the representative vertex not
        # in the supernode (find_separators, supernode_tree.jl:198-223)
        self.separators: List[Set[int]] = []
        for sn in snode:
            vrep = min(sn)
            self.separators.append({u for u in Lcols[vrep] if u not in sn})

        self.snode_post = post_order(
            self.snode_parent, self.snode_children, nsn
        )
        self.nblk = None

    # -- postorder accessors (supernode_tree.jl:70-107) -----------------
    def get_snode(self, i: int):
        return self.snode[self.snode_post[i]]

    def get_separators(self, i: int):
        return self.separators[self.snode_post[i]]

    def get_clique_parent(self, i: int):
        return self.snode_parent[self.snode_post[i]]

    def get_clique(self, i: int):
        c = self.snode_post[i]
        return self.snode[c] | self.separators[c]

    def get_clique_by_index(self, c: int):
        return self.snode[c] | self.separators[c]

    def get_nblk(self, i: int):
        return self.nblk[i]

    def get_overlap(self, i: int):
        return len(self.separators[self.snode_post[i]])

    def get_decomposed_dim_and_overlaps(self):
        dim = 0
        overlaps = 0
        for i in range(self.n_cliques):
            dim += _tri(self.get_nblk(i))
            overlaps += _tri(self.get_overlap(i))
        return dim, overlaps

    # -- post-merge processing ------------------------------------------
    def reorder_snode_consecutively(self, ordering: np.ndarray) -> np.ndarray:
        """Relabel vertices so each supernode is a consecutive range
        (needed for PSD completion); updates and returns the ordering
        map tree-vertex -> original vertex
        (reorder_snode_consecutively!, supernode_tree.jl:117-156)."""
        n = len(self.post)
        p = np.zeros(n, dtype=np.int64)
        k = 0
        for i in self.snode_post:
            sn = sorted(self.snode[i])
            m = len(sn)
            p[k : k + m] = sn
            self.snode[i] = set(range(k, k + m))
            k += m
        p_inv = np.argsort(p)
        self.separators = [
            {int(p_inv[v]) for v in sp} for sp in self.separators
        ]
        return ordering[p]

    def calculate_block_dimensions(self):
        self.nblk = [
            len(self.separators[c]) + len(self.snode[c])
            for c in (self.snode_post[i] for i in range(self.n_cliques))
        ]


def _tri(k: int) -> int:
    return k * (k + 1) // 2
