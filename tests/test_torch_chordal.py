"""The port's copy of the chordal decomposition (cuclarabel_torch/chordal/)
against the reference's (cuclarabel_tpu/chordal/).

Both take the filled graph from their native C++ LDL^T package
(`graph._native_symbolic`; the port's own `native/`), with the
row-subtree symbolic factorisation (`etree` + `symbolic_cholesky`)
where that numeric factor fails, so the two fills are held against each
other on each side and across, then the cliques, the vertex ordering
and the clique tree of every decomposed cone, the augmented problems
(`decomp_augment`) bit for bit and the reverse transforms
(`decomp_reverse`) on seeded random iterates.  Data:
tests/test_sdp_chordal.py's problem under all 12 settings (compact x
complete_dual x merge method) and problems.sdp_chordal_banded at
nv = 10, 11 and 12."""

import itertools

import numpy as np
import pytest

from cuclarabel_tpu.chordal import decomp as ref_decomp
from cuclarabel_tpu.chordal import graph as ref_graph
from cuclarabel_tpu.settings import Settings as RefSettings
from cuclarabel_torch import interop
from cuclarabel_torch.chordal import decomp, graph
from cuclarabel_torch.cones import api
from cuclarabel_torch.problems import sdp_chordal_banded
from cuclarabel_torch.settings import Settings
from tests.test_sdp_chordal import sdp_chordal_data

COMBOS = list(itertools.product(
    [False, True], [False, True], ["clique_graph", "parent_child", "none"]))


def _problems():
    P, q, A, b, cones = sdp_chordal_data()
    yield "sdp_chordal", (P, q, A, b, cones)
    for nv in (10, 11, 12):
        _, q, A, b, cones = sdp_chordal_banded(nv, 2, 6)
        yield f"banded{nv}", (np.zeros((len(q), len(q))), q, A, b, cones)


PROBLEMS = dict(_problems())
CASES = ([("sdp_chordal", c) for c in COMBOS]
         + [(f"banded{nv}", c) for nv in (10, 11, 12)
            for c in (COMBOS[0], COMBOS[7], COMBOS[-1])])


def _settings(combo):
    compact, complete_dual, merge = combo
    kw = dict(chordal_decomposition_compact=compact,
              chordal_decomposition_complete_dual=complete_dual,
              chordal_decomposition_merge_method=merge)
    return Settings(**kw), RefSettings(**kw)


def _cones(name):
    """The problem's cones as each side builds them."""
    P, q, A, b, cones = PROBLEMS[name]
    if name == "sdp_chordal":
        return interop.cones_from_reference(cones), cones
    import cuclarabel_tpu as cc

    ref = [getattr(cc, type(c).__name__)(c.dim) for c in cones]
    return cones, ref


def _spec(c):
    return (type(c).__name__, getattr(c, "dim", None),
            getattr(c, "alpha", None))


def _tree(sp):
    t = sp.sntree
    return {"ordering": [int(v) for v in sp.ordering],
            "n_cliques": t.n_cliques,
            "cliques": [sorted(t.get_clique(i)) for i in range(t.n_cliques)],
            "snodes": [sorted(t.get_snode(i)) for i in range(t.n_cliques)],
            "parents": [t.get_clique_parent(i) for i in range(t.n_cliques)],
            "nblk": list(t.nblk), "orig_index": sp.orig_index}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_the_two_fills_agree(name):
    """The reference's fill (native when built), the copy's native fill
    and its row-subtree fill give the same column patterns on every PSD
    cone's aggregate sparsity pattern, at every permutation find_graph
    makes."""
    P, q, A, b, _ = PROBLEMS[name]
    nz = (np.abs(A).sum(axis=1) != 0) | (b != 0)
    ofs = 0
    for c in _cones(name)[0]:
        d = api.nvars(c)
        if isinstance(c, api.PSDTriangleConeT):
            mask = nz[ofs:ofs + d].copy()
            for k in range(c.dim):
                mask[(k + 1) * (k + 2) // 2 - 1] = True
            assert graph.find_graph(mask, c.dim)[0] == \
                ref_graph.find_graph(mask, c.dim)[0]
            assert [int(v) for v in graph.find_graph(mask, c.dim)[1]] == \
                [int(v) for v in ref_graph.find_graph(mask, c.dim)[1]]
            pat = np.zeros((c.dim, c.dim), bool)
            a = 0
            for j in range(c.dim):
                for i in range(j + 1):
                    pat[i, j] = mask[a]
                    a += 1
            np.fill_diagonal(pat, True)
            perm = graph.min_degree_ordering(pat | pat.T)
            pat_u = np.triu((pat | pat.T)[np.ix_(perm, perm)])
            native = ref_graph._native_symbolic(pat_u)
            own = graph.symbolic_cholesky(pat_u, graph.etree(pat_u))
            assert own == ref_graph.symbolic_cholesky(
                pat_u, ref_graph.etree(pat_u))
            if native is not None:
                assert own == native
            assert graph._native_symbolic(pat_u) == own
        ofs += d


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_find_graph_takes_the_native_fill(name, monkeypatch):
    """find_graph's filled graph comes from the native package, and the
    row-subtree fill, taken where the native factor fails, gives the
    same graph."""
    P, q, A, b, _ = PROBLEMS[name]
    nz = (np.abs(A).sum(axis=1) != 0) | (b != 0)
    ofs = 0
    for c in _cones(name)[0]:
        d = api.nvars(c)
        if isinstance(c, api.PSDTriangleConeT):
            mask = nz[ofs:ofs + d].copy()
            for k in range(c.dim):
                mask[(k + 1) * (k + 2) // 2 - 1] = True
            calls = []
            native_fill = graph._native_symbolic

            def counted(pat_u):
                calls.append(pat_u.shape[0])
                return native_fill(pat_u)

            monkeypatch.setattr(graph, "_native_symbolic", counted)
            via_native = graph.find_graph(mask, c.dim)
            assert calls == [c.dim]
            monkeypatch.setattr(graph, "_native_symbolic", lambda pat_u: None)
            via_subtree = graph.find_graph(mask, c.dim)
            monkeypatch.setattr(graph, "_native_symbolic", native_fill)
            assert via_native[0] == via_subtree[0]
            np.testing.assert_array_equal(via_native[1], via_subtree[1])
        ofs += d


@pytest.mark.parametrize("name,combo", CASES,
                         ids=[f"{n}-{'-'.join(map(str, c))}"
                              for n, c in CASES])
def test_decomposition_matches_reference(name, combo):
    P, q, A, b, _ = PROBLEMS[name]
    cones, ref_cones = _cones(name)
    st, ref_st = _settings(combo)
    info = decomp.ChordalInfo(A, b, cones, st)
    ref = ref_decomp.ChordalInfo(A, b, ref_cones, ref_st)
    # parent_child merges this small problem's cliques back into one
    assert info.is_decomposed() == ref.is_decomposed()
    assert info.is_decomposed() or combo[2] == "parent_child"
    assert [_tree(sp) for sp in info.spatterns] == \
        [_tree(sp) for sp in ref.spatterns]
    if not info.is_decomposed():
        return

    out = decomp.decomp_augment(info, P, q, A, b, st)
    want = ref_decomp.decomp_augment(ref, P, q, A, b, ref_st)
    for got, w in zip(out[:4], want[:4]):
        np.testing.assert_array_equal(got, w)
    assert [_spec(c) for c in out[4]] == [_spec(c) for c in want[4]]

    rng = np.random.default_rng(len(name) + sum(map(len, map(str, combo))))
    n, m = out[1].shape[0], out[3].shape[0]
    x, s, z = (rng.standard_normal(k) for k in (n, m, m))
    for got, w in zip(decomp.decomp_reverse(info, x, s, z, st),
                      ref_decomp.decomp_reverse(ref, x, s, z, ref_st)):
        np.testing.assert_array_equal(got, w)
