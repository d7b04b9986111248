"""The port's native sparse LDL^T (cuclarabel_torch/native/) against the
reference's (cuclarabel_tpu/native/).

Both load the same C++ source (the port's is a copy, built into build/),
so factors, solves, orderings and the symbolic structure are held equal
bit for bit, on seeded random quasidefinite KKT matrices: refactor
reuse, the dynamic-regularization rescue of a zero pivot, the signs of
D, max_threads = 2 against the sequential sweep, and the Solver with
direct_solve_method="qdldl" and max_threads = 2.  Tolerance: none
(bitwise), except the Solver, held within 1e-9 of the reference's x."""

import numpy as np
import pytest
import scipy.sparse as sp

import cuclarabel_tpu as cc
from cuclarabel_tpu import native as ref_native
import cuclarabel_torch as ct
from cuclarabel_torch import native


def _dense_to_upper_csc(K):
    n = K.shape[0]
    Ap = [0]
    Ai, Ax = [], []
    for j in range(n):
        for i in range(j + 1):
            if K[i, j] != 0.0 or i == j:
                Ai.append(i)
                Ax.append(K[i, j])
        Ap.append(len(Ai))
    return np.asarray(Ap), np.asarray(Ai), np.asarray(Ax)


def _random_kkt(rng, n, m, density=0.4):
    F = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    P = F @ F.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    H = np.diag(rng.random(m) + 0.5)
    K = np.block([[P, A.T], [A, -H]])
    dsigns = np.concatenate([np.ones(n), -np.ones(m)]).astype(np.int64)
    return K, dsigns


def _both(N, Ap, Ai, dsigns, **kw):
    return (native.LDLFactor(N, Ap, Ai, dsigns, **kw),
            ref_native.LDLFactor(N, Ap, Ai, dsigns, **kw))


def _same_factor(a, b):
    for name in ("etree", "Lcnt", "Lp", "Li", "Lx", "D", "Dinv"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def test_the_library_is_built_in_build_dir():
    path = native.build()
    assert path.exists() and path.parent.name == "build"
    assert native.library_path() == path


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "ldl.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


@pytest.mark.parametrize("n,m,seed", [(12, 9, 7), (30, 20, 8), (5, 40, 9)])
def test_factor_and_solve_match_reference(n, m, seed):
    rng = np.random.default_rng(seed)
    K, dsigns = _random_kkt(rng, n, m)
    Ap, Ai, Ax = _dense_to_upper_csc(K)
    mine, ref = _both(n + m, Ap, Ai, dsigns, reg_enable=False)
    assert mine.nnzL == ref.nnzL
    assert mine.refactor(Ax) and ref.refactor(Ax)
    _same_factor(mine, ref)
    for _ in range(3):
        b = rng.standard_normal(n + m)
        x = mine.solve(b)
        np.testing.assert_array_equal(x, ref.solve(b))
        assert np.linalg.norm(K @ x - b) < 1e-8 * np.linalg.norm(b)


def test_refactor_reuses_symbolic():
    rng = np.random.default_rng(3)
    n, m = 8, 5
    K, dsigns = _random_kkt(rng, n, m)
    Ap, Ai, Ax = _dense_to_upper_csc(K)
    mine, ref = _both(n + m, Ap, Ai, dsigns)
    assert mine.refactor(Ax) and ref.refactor(Ax)
    K2 = K.copy()
    K2[n:, n:] -= np.eye(m)  # strengthen the -H block
    _, _, Ax2 = _dense_to_upper_csc(K2)
    Li = mine.Li.copy()
    assert mine.refactor(Ax2) and ref.refactor(Ax2)
    np.testing.assert_array_equal(mine.Li, Li)
    _same_factor(mine, ref)
    b = rng.standard_normal(n + m)
    x = mine.solve(b)
    np.testing.assert_array_equal(x, ref.solve(b))
    assert np.linalg.norm(K2 @ x - b) < 1e-8 * np.linalg.norm(b)


def test_dynamic_regularization_rescues_zero_pivot():
    K = np.array([[1.0, 1.0], [1.0, 1.0]])  # singular
    Ap, Ai, Ax = _dense_to_upper_csc(K)
    dsigns = np.array([1, -1], dtype=np.int64)
    mine, ref = _both(2, Ap, Ai, dsigns, reg_enable=True, delta=2e-7)
    assert mine.refactor(Ax) and ref.refactor(Ax)
    assert np.isfinite(mine.D).all() and mine.D[1] == -2e-7
    _same_factor(mine, ref)
    # without the regularization the zero pivot is not rescued
    off, _ = _both(2, Ap, Ai, dsigns, reg_enable=False)
    assert not off.refactor(Ax)


def test_signs_match_quasidefiniteness():
    rng = np.random.default_rng(4)
    n, m = 6, 4
    K, dsigns = _random_kkt(rng, n, m)
    Ap, Ai, Ax = _dense_to_upper_csc(K)
    mine, ref = _both(n + m, Ap, Ai, dsigns, reg_enable=False)
    assert mine.refactor(Ax) and ref.refactor(Ax)
    np.testing.assert_array_equal(np.sign(mine.D), dsigns)
    np.testing.assert_array_equal(np.sign(mine.D), np.sign(ref.D))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mindeg_ordering_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 40
    M = rng.random((n, n)) < 0.15
    M = M | M.T
    np.fill_diagonal(M, False)
    Ap = [0]
    Ai = []
    for j in range(n):
        Ai.extend(np.nonzero(M[:, j])[0])
        Ap.append(len(Ai))
    perm = native.mindeg_ordering(n, np.asarray(Ap), np.asarray(Ai))
    assert sorted(perm.tolist()) == list(range(n))
    np.testing.assert_array_equal(
        perm, ref_native.mindeg_ordering(n, np.asarray(Ap), np.asarray(Ai)))


def test_parallel_refactor_matches_sequential():
    """max_threads = 2 (level-parallel sweep) is bitwise the sequential
    sweep and the reference's, and a chain etree stays sequential."""
    rng = np.random.default_rng(3)
    nb, bs_ = 50, 8
    blocks = []
    for _ in range(nb):
        G = rng.standard_normal((bs_, bs_))
        blocks.append(G @ G.T + bs_ * np.eye(bs_))
    n = nb * bs_
    Ku = sp.triu(sp.block_diag(blocks).tocsc()).tocsc()
    ds = np.ones(n, dtype=np.int64)
    f1 = native.LDLFactor(n, Ku.indptr, Ku.indices, ds, max_threads=1)
    f2 = native.LDLFactor(n, Ku.indptr, Ku.indices, ds, max_threads=2)
    r2 = ref_native.LDLFactor(n, Ku.indptr, Ku.indices, ds, max_threads=2)
    assert f2.nthreads == 2 and r2.nthreads == 2
    assert f1.refactor(Ku.data) and f2.refactor(Ku.data)
    assert r2.refactor(Ku.data)
    _same_factor(f1, f2)
    _same_factor(f2, r2)
    b = rng.standard_normal(n)
    np.testing.assert_array_equal(f1.solve(b), f2.solve(b))

    m = 256
    T = sp.diags([4 * np.ones(m), np.ones(m - 1), np.ones(m - 1)],
                 [0, 1, -1]).tocsc()
    Tu = sp.triu(T).tocsc()
    fc = native.LDLFactor(m, Tu.indptr, Tu.indices,
                          np.ones(m, dtype=np.int64), max_threads=4)
    assert fc.nthreads == 1


def test_max_threads_through_solver():
    """settings.max_threads reaches the native backend through the
    Solver (the reference forwards it, settings.jl:108-110)."""
    P = np.array([[2.0, 0.0], [0.0, 2.0]])
    q = np.array([-1.0, -1.0])
    A = -np.eye(2)
    b = np.zeros(2)
    sol = ct.Solver(P, q, A, b, [ct.NonnegativeConeT(2)], device="cpu",
                    direct_solve_method="qdldl", max_threads=2).solve()
    ref = cc.Solver(P, q, A, b, [cc.NonnegativeConeT(2)],
                    direct_solve_method="qdldl", max_threads=2).solve()
    assert sol.status == ct.SolverStatus.SOLVED
    assert sol.iterations == ref.iterations
    np.testing.assert_allclose(sol.x, ref.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sol.x, [0.5, 0.5], atol=1e-7)
