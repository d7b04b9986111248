"""Clique merge strategies.

A copy of `cuclarabel_tpu/chordal/merge.py` (numpy only; the port
imports nothing of the JAX package).

Behavioral parity with `src/chordal/merge_strategy/`:

  * NoMerge  — passthrough (nomerge.jl);
  * ParentChild — COSMO-style fill-in / cardinality heuristic merging
    up the tree (parent_child.jl);
  * CliqueGraph (default) — reduced clique graph with cubic edge
    weights (computational-savings metric), merge highest positive
    weight permissible pairs, then recover a clique tree by Kruskal
    maximum-weight spanning tree for PSD completion (clique_graph.jl;
    Garstka-Cannon-Goulart 2019).
"""

from typing import Dict, List, Set, Tuple

from .sntree import INACTIVE, NO_PARENT, SuperNodeTree, post_order


def merge_cliques(method: str, t: SuperNodeTree) -> None:
    if method in ("none", "nomerge"):
        return
    if method == "parent_child":
        _merge_parent_child(t)
    elif method == "clique_graph":
        _merge_clique_graph(t)
    else:
        raise ValueError(f"Unknown merge strategy: {method}")


# ---------------------------------------------------------------------------
# parent-child strategy (parent_child.jl)
# ---------------------------------------------------------------------------


def _fill_in(cs, csep, ps, psep):
    dim_parent = ps + psep
    dim_clique = cs + csep
    return (dim_parent - csep) * (dim_clique - csep)


def _merge_parent_child(t: SuperNodeTree, t_fill: int = 8, t_size: int = 8):
    for idx in range(len(t.snode) - 2, -1, -1):
        ch = t.snode_post[idx]
        p = t.snode_parent[ch]
        if p in (NO_PARENT, INACTIVE):
            continue
        fill = _fill_in(
            len(t.snode[ch]), len(t.separators[ch]),
            len(t.snode[p]), len(t.separators[p]),
        )
        max_snode = max(len(t.snode[ch]), len(t.snode[p]))
        if fill <= t_fill or max_snode <= t_size:
            # merge child into parent (merge_two_cliques!,
            # parent_child.jl:102-131)
            t.snode[p] |= t.snode[ch]
            t.snode[ch] = set()
            t.separators[ch] = set()
            for g in t.snode_children[ch]:
                t.snode_parent[g] = p
            t.snode_parent[ch] = INACTIVE
            t.snode_children[p].discard(ch)
            t.snode_children[p] |= t.snode_children[ch]
            t.snode_children[ch] = set()
            t.n_cliques -= 1
    t.snode_post = post_order(t.snode_parent, t.snode_children, t.n_cliques)


# ---------------------------------------------------------------------------
# clique-graph strategy (clique_graph.jl)
# ---------------------------------------------------------------------------


def _edge_metric(ca: Set[int], cb: Set[int]) -> int:
    """Cubic computational-savings weight (edge_metric,
    clique_graph.jl:697-712)."""
    n1, n2 = len(ca), len(cb)
    nm = len(ca | cb)
    return n1**3 + n2**3 - nm**3


def _reduced_clique_graph(separators, snode):
    """Union-of-clique-trees edge set via the Habib-Stacho separator
    construction (compute_reduced_clique_graph!,
    clique_graph.jl:331-371)."""
    edges = set()
    for sep in sorted(separators, key=len, reverse=True):
        cl_idx = [i for i, sn in enumerate(snode) if sep <= sn]
        # separator graph: cliques whose pairwise intersection exceeds sep
        H: Dict[int, List[int]] = {v: [] for v in cl_idx}
        for a in range(len(cl_idx)):
            for b in range(a + 1, len(cl_idx)):
                ca, cb = cl_idx[a], cl_idx[b]
                if (snode[ca] & snode[cb]) != sep:
                    H[ca].append(cb)
                    H[cb].append(ca)
        # connected components of H
        comp_of = {}
        cid = 0
        for v in cl_idx:
            if v in comp_of:
                continue
            stack = [v]
            while stack:
                u = stack.pop()
                if u in comp_of:
                    continue
                comp_of[u] = cid
                stack.extend(H[u])
            cid += 1
        for a in range(len(cl_idx)):
            for b in range(a + 1, len(cl_idx)):
                if comp_of[cl_idx[a]] != comp_of[cl_idx[b]]:
                    e = (max(cl_idx[a], cl_idx[b]), min(cl_idx[a], cl_idx[b]))
                    edges.add(e)
    return edges


def _is_permissible(edge, adjacency, snode):
    """Permissible if every common neighbor N has C1 ∩ N == C2 ∩ N
    (ispermissible, clique_graph.jl:525-543)."""
    c1, c2 = edge
    for nb in adjacency[c1] & adjacency[c2]:
        if (snode[c1] & snode[nb]) != (snode[c2] & snode[nb]):
            return False
    return True


def _merge_clique_graph(t: SuperNodeTree):
    # absorb separators into supernodes: nodes now represent full cliques
    for i in range(len(t.snode)):
        t.snode[i] |= t.separators[i]
        t.snode_parent[i] = INACTIVE
        t.snode_children[i] = set()

    edge_set = _reduced_clique_graph(t.separators, t.snode)
    weights: Dict[Tuple[int, int], int] = {
        e: _edge_metric(t.snode[e[0]], t.snode[e[1]]) for e in edge_set
    }
    adjacency: Dict[int, Set[int]] = {i: set() for i in range(len(t.snode))}
    for (a, b) in edge_set:
        adjacency[a].add(b)
        adjacency[b].add(a)

    # main merge loop (merge_cliques!, defaults.jl:3-26)
    while weights:
        cand = None
        for e in sorted(weights, key=lambda e: -weights[e]):
            if _is_permissible(e, adjacency, t.snode):
                cand = e
                break
        if cand is None or weights[cand] < 0:
            break
        c1, c2 = cand
        # merge c2 into c1
        t.snode[c1] |= t.snode[c2]
        t.snode[c2] = set()
        t.n_cliques -= 1

        # update edges / adjacency (update_strategy!,
        # clique_graph.jl:144-199)
        neighbors = adjacency[c1].copy()
        new_neighbors = adjacency[c2] - neighbors - {c1}
        for n in neighbors:
            if n != c2:
                key = (max(c1, n), min(c1, n))
                weights[key] = _edge_metric(t.snode[c1], t.snode[n])
        for n in new_neighbors:
            key = (max(c1, n), min(c1, n))
            weights[key] = _edge_metric(t.snode[c1], t.snode[n])
        # drop all edges touching c2
        for key in [k for k in weights if c2 in k]:
            del weights[key]
        adjacency[c1] |= new_neighbors
        for n in new_neighbors:
            adjacency[n].add(c1)
        for n in adjacency.pop(c2, set()):
            adjacency[n].discard(c2)
        adjacency[c1].discard(c2)
        if t.n_cliques == 1:
            break

    _clique_tree_from_graph(t)


def _clique_tree_from_graph(t: SuperNodeTree):
    """Recover a clique tree: Kruskal max-weight spanning tree on
    |Ci ∩ Cj|, root at the clique containing the highest-order vertex,
    then split cliques into supernodes/separators
    (clique_tree_from_graph!, clique_graph.jl:256-289)."""
    alive = [i for i in range(len(t.snode)) if t.snode[i]]
    t.snode_post = list(alive)
    t.snode_parent = [INACTIVE] * len(t.snode)
    t.snode_children = [set() for _ in t.snode]

    if t.n_cliques > 1:
        # candidate edges between all alive clique pairs that intersect
        cand = []
        for a in range(len(alive)):
            for b in range(a + 1, len(alive)):
                i, j = alive[a], alive[b]
                w = len(t.snode[i] & t.snode[j])
                if w > 0:
                    cand.append((w, i, j))
        cand.sort(key=lambda x: -x[0])

        parent_ds = {i: i for i in alive}

        def find(x):
            while parent_ds[x] != x:
                parent_ds[x] = parent_ds[parent_ds[x]]
                x = parent_ds[x]
            return x

        mst = set()
        found = 0
        for w, i, j in cand:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent_ds[ri] = rj
                mst.add((i, j))
                found += 1
                if found >= t.n_cliques - 1:
                    break

        # root: clique containing the highest-order vertex
        v = t.post[-1]
        root = next(k for k in alive if v in t.snode[k])
        t.snode_parent[root] = NO_PARENT
        stack = [root]
        adj: Dict[int, Set[int]] = {i: set() for i in alive}
        for (i, j) in mst:
            adj[i].add(j)
            adj[j].add(i)
        visited = {root}
        while stack:
            c = stack.pop()
            for n in adj[c]:
                if n not in visited:
                    visited.add(n)
                    t.snode_parent[n] = c
                    t.snode_children[c].add(n)
                    stack.append(n)

        t.snode_post = post_order(t.snode_parent, t.snode_children, t.n_cliques)

        # split cliques into supernodes and separators (split_cliques!,
        # clique_graph.jl:616-635)
        t.separators = [set() for _ in t.snode]
        for jdx in range(t.n_cliques - 1):
            c = t.snode_post[jdx]
            p = t.snode_parent[c]
            t.separators[c] = t.snode[c] & t.snode[p]
            t.snode[c] = t.snode[c] - t.separators[c]
    else:
        root = alive[0]
        t.snode_parent[root] = NO_PARENT
        t.snode_post = [root]
        t.separators = [set() for _ in t.snode]
