"""The port's copy of the host symbolic analysis (kkt/sparse_symbolic.py)
and of the numeric plan (kkt/sparse_device.py's numpy part) against the
reference's.

On seeded random quasidefinite patterns and on the K pattern of the
k = 8 grid QP (the one `make_sparse_tpu_kkt` builds, with its nested
dissection): the elimination tree and column counts, the minimum-degree
ordering (the port's own native library), the supernodes, their rows,
parents and levels, the split of wide supernodes, the value permutation
and `NumericPlan.device_arrays()` equal to the reference's array for
array, and the port's whole host analysis (`_host_analysis`) equal to
the reference's host_bufs.  Tolerance: none (integer maps, exact)."""

import numpy as np
import pytest
import scipy.sparse as sp

from cuclarabel_tpu.cones import api as ref_api
from cuclarabel_tpu.cones.layout import build_layout as ref_build_layout
from cuclarabel_tpu.kkt import sparse_device as ref_dev
from cuclarabel_tpu.kkt import sparse_symbolic as ref_ss
from cuclarabel_tpu.kkt.sparse_tpu import SparseProblem as RefSparseProblem
from cuclarabel_tpu.kkt.sparse_tpu import make_sparse_tpu_kkt as ref_make
from cuclarabel_tpu.settings import Settings as RefSettings
from cuclarabel_torch import interop, problems
from cuclarabel_torch.cones.layout import build_layout
from cuclarabel_torch.kkt import sparse_device as dev
from cuclarabel_torch.kkt import sparse_symbolic as ss
from cuclarabel_torch.kkt.sparse_tpu import _host_analysis


def _upper_csc(M):
    U = sp.triu(sp.csc_matrix(M)).tocsc()
    U.sort_indices()
    return U.indptr.astype(np.int64), U.indices.astype(np.int64)


def _random_kkt_pattern(seed, n, m, density):
    rs = np.random.RandomState(seed)
    A = sp.random(m, n, density=density, random_state=rs, format="csc")
    G = sp.random(n, n, density=density, random_state=rs, format="csc")
    P = G @ G.T + sp.eye(n)
    K = sp.bmat([[P, A.T], [A, -sp.eye(m)]], format="csc")
    return n + m, K, np.concatenate([np.ones(n), -np.ones(m)])


def _grid_kkt(k):
    P, q, A, b, cones = problems.grid_qp(k)
    n, m = q.shape[0], b.shape[0]
    K = sp.bmat([[P, A.T], [None, -sp.eye(m)]], format="csc")
    return n + m, K, np.concatenate([np.ones(n), -np.ones(m)])


def _same_sym(a, b):
    for name in ("perm", "iperm", "sn_starts", "sn_level", "sn_parent",
                 "Ap", "Ai"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert len(a.sn_rows) == len(b.sn_rows)
    for ra, rb in zip(a.sn_rows, b.sn_rows):
        np.testing.assert_array_equal(ra, rb)
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        np.testing.assert_array_equal(la, lb)


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


CASES = {
    "random_40_30": lambda: _random_kkt_pattern(1, 40, 30, 0.08),
    "random_25_60": lambda: _random_kkt_pattern(2, 25, 60, 0.05),
    "grid_k8": lambda: _grid_kkt(8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_etree_and_colcounts_match(name):
    N, K, _ = CASES[name]()
    Ap, Ai = _upper_csc(K)
    parent, cc = ss.etree_colcounts(N, Ap, Ai)
    rparent, rcc = ref_ss.etree_colcounts(N, Ap, Ai)
    np.testing.assert_array_equal(parent, rparent)
    np.testing.assert_array_equal(cc, rcc)
    assert ss.row_patterns(N, Ap, Ai, parent) == \
        ref_ss.row_patterns(N, Ap, Ai, rparent)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("ordering", ["mindeg", "dissection", "natural"])
def test_analysis_and_plan_match(name, ordering):
    N, K, dsigns = CASES[name]()
    Ap, Ai = _upper_csc(K)
    order = {"mindeg": None, "natural": np.arange(N),
             "dissection": ss.nested_dissection(N, Ap, Ai)}[ordering]
    if ordering == "dissection":
        np.testing.assert_array_equal(order,
                                      ref_ss.nested_dissection(N, Ap, Ai))
    sym = ss.analyze(N, Ap, Ai, order=order)
    rsym = ref_ss.analyze(N, Ap, Ai, order=order)
    _same_sym(sym, rsym)
    for width in (4, 32):
        s2 = dev._split_wide_supernodes(sym, width)
        r2 = ref_dev._split_wide_supernodes(rsym, width)
        _same_sym(s2, r2)
        plan = dev.build_numeric_plan(s2, dsigns)
        rplan = ref_dev.build_numeric_plan(r2, dsigns)
        _same_arrays(plan.device_arrays(),
                     interop.plan_arrays_from_reference(rplan))
        assert plan.ubuf_size == rplan.ubuf_size
        assert plan.n_sched_levels == rplan.n_sched_levels
        nnz = int(Ai.shape[0])
        assert plan.memory_estimate_bytes(nnz) == \
            rplan.memory_estimate_bytes(nnz)
        np.testing.assert_array_equal(
            dev._value_permutation(N, Ap, Ai, s2),
            ref_dev._value_permutation(N, Ap, Ai, r2))


def test_mindeg_comes_from_the_native_library(monkeypatch):
    """Without the native library the copy raises where the reference
    falls back to the natural order."""
    from cuclarabel_torch import native

    N, K, _ = CASES["random_40_30"]()
    Ap, Ai = _upper_csc(K)

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "get_lib", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ss.analyze(N, Ap, Ai)


@pytest.mark.parametrize("k", [6, 8])
def test_host_analysis_matches_reference(k):
    """The port's K pattern, value maps, plan and SpMV triplets are the
    reference's make_sparse_tpu_kkt host_bufs, array for array."""
    P, q, A, b, _ = problems.grid_qp(k)
    n, m = q.shape[0], b.shape[0]
    ref_sp = RefSparseProblem.from_scipy(P, A)
    _, _, ref_bufs = ref_make(
        n, m, RefSettings(), ref_build_layout((ref_api.NonnegativeConeT(m),)),
        ref_sp)
    from cuclarabel_torch.cones import api

    h = _host_analysis(n, m, build_layout((api.NonnegativeConeT(m),)),
                       interop.sparse_problem_from_reference(ref_sp), 32)
    _same_arrays(h["host_bufs"], ref_bufs)
