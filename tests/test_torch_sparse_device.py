"""The port's device multifrontal LDL^T (kkt/sparse_device.py, plain
torch, here on the CPU) against the reference's (XLA on the CPU) and
against numpy's dense solve.

The reference's cases of tests/test_sparse_device.py (random sparse
quasidefinite K at (n, m, max_width) = (15, 20, 4), (40, 55, 8),
(25, 25, 32), a refactor with new values, the zero pivot and the k = 10
grid-structured K) hold x within 1e-10 relative of both, and D^-1's
signs equal to the reference's.  A batch of B = 3 value sets is held to
three single factorizations (1e-13 relative), the f32 fronts to numpy
within 1e-4 relative, and the deterministic scatter plans
(kkt/scatter.py) to numpy's unordered sums (1e-14 relative)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cuclarabel_tpu.kkt.sparse_device import SparseDeviceLDL as RefLDL
from cuclarabel_torch.kkt.scatter import Scatter, SegmentSum
from cuclarabel_torch.kkt.sparse_device import SparseDeviceLDL

TOL = 1e-10


def _upper_csc(M):
    U = sp.triu(sp.csc_matrix(M)).tocsc()
    U.sort_indices()
    return (U.indptr.astype(np.int64), U.indices.astype(np.int64),
            np.asarray(U.data, dtype=np.float64))


def _kkt_sparse(rng, n, m, density=0.1):
    """Sparse quasidefinite [P A'; A -H] with H diagonal positive (the
    reference test's generator)."""
    A = sp.random(m, n, density=density,
                  random_state=np.random.RandomState(1), format="csc")
    A = A + 0.01 * sp.eye(m, n)
    G = sp.random(n, n, density=density,
                  random_state=np.random.RandomState(2), format="csc")
    P = G @ G.T + sp.eye(n)
    H = sp.diags(10.0 ** rng.uniform(-2, 2, m))
    K = sp.bmat([[P, A.T], [A, -H]], format="csc")
    dsigns = np.concatenate([np.ones(n), -np.ones(m)])
    return K, dsigns


def _rel(x, y):
    return np.abs(x - y).max() / max(np.abs(y).max(), 1.0)


def _ref_dinv(ref):
    """The reference's D^-1 without its padding slot N."""
    return np.asarray(ref._fac["Dinv"])[:ref.N]


def _dinv(mine):
    return mine._fac["Dinv"][0, :mine.N].numpy()


@pytest.mark.parametrize("n,m,mw", [(15, 20, 4), (40, 55, 8), (25, 25, 32)])
def test_matches_reference_and_dense(n, m, mw):
    rng = np.random.default_rng(0)
    K, dsigns = _kkt_sparse(rng, n, m)
    N = n + m
    Ap, Ai, Ax = _upper_csc(K)
    mine = SparseDeviceLDL(N, Ap, Ai, dsigns, reg_enable=False,
                           max_width=mw, device="cpu")
    ref = RefLDL(N, Ap, Ai, dsigns, reg_enable=False, max_width=mw)
    assert mine.refactor(Ax) and ref.refactor(Ax)
    np.testing.assert_array_equal(
        np.sign(_dinv(mine)), np.sign(_ref_dinv(ref)))
    for _ in range(2):
        b = rng.standard_normal(N)
        x = mine.solve(b)
        assert _rel(x, ref.solve(b)) < TOL
        assert _rel(x, np.linalg.solve(K.toarray(), b)) < TOL


def test_refactor_reuses_symbolic():
    rng = np.random.default_rng(3)
    K, dsigns = _kkt_sparse(rng, 20, 25)
    N = 45
    Ap, Ai, Ax = _upper_csc(K)
    mine = SparseDeviceLDL(N, Ap, Ai, dsigns, reg_enable=False,
                           device="cpu")
    ref = RefLDL(N, Ap, Ai, dsigns, reg_enable=False)
    assert mine.refactor(Ax)
    Ax2 = Ax * rng.uniform(0.5, 2.0, Ax.shape[0])
    K2 = sp.csc_matrix((Ax2, Ai, Ap), shape=(N, N))
    Kfull = (K2 + sp.triu(K2, 1).T).toarray()
    maps = mine.maps
    assert mine.refactor(Ax2) and ref.refactor(Ax2)
    assert mine.maps is maps
    b = rng.standard_normal(N)
    x = mine.solve(b)
    assert _rel(x, ref.solve(b)) < TOL
    assert _rel(x, np.linalg.solve(Kfull, b)) < 1e-7


def test_dynamic_regularization_zero_pivot():
    """A singular K: the zero pivot takes dsign * delta
    (directldl_qdldl.jl:18-25), on both sides alike."""
    N = 3
    Ap = np.array([0, 1, 3, 4])
    Ai = np.array([0, 0, 1, 2])
    Ax = np.array([1.0, 1.0, 1.0, -1.0])
    dsigns = np.array([1.0, -1.0, -1.0])
    mine = SparseDeviceLDL(N, Ap, Ai, dsigns, reg_enable=True, eps=1e-13,
                           delta=2e-7, device="cpu")
    ref = RefLDL(N, Ap, Ai, dsigns, reg_enable=True, eps=1e-13, delta=2e-7)
    assert mine.refactor(Ax) and ref.refactor(Ax)
    dinv = _dinv(mine)
    np.testing.assert_array_equal(np.sign(dinv), np.sign(_ref_dinv(ref)))
    np.testing.assert_allclose(dinv, _ref_dinv(ref), rtol=1e-15)
    b = np.array([1.0, 2.0, 3.0])
    x = mine.solve(b)
    assert np.all(np.isfinite(x))
    assert _rel(x, ref.solve(b)) < TOL


def test_larger_grid_structure():
    rng = np.random.default_rng(4)
    k = 10
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (k, k))
    n = k * k
    P = (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k)) + sp.eye(n)).tocsc()
    A = sp.eye(n, n, format="csc") + sp.diags(np.ones(n - 1), 1, (n, n))
    H = sp.diags(10.0 ** rng.uniform(-1, 1, n))
    K = sp.bmat([[P, A.T], [A, -H]], format="csc")
    N = 2 * n
    dsigns = np.concatenate([np.ones(n), -np.ones(n)])
    Ap, Ai, Ax = _upper_csc(K)
    mine = SparseDeviceLDL(N, Ap, Ai, dsigns, reg_enable=False,
                           device="cpu")
    ref = RefLDL(N, Ap, Ai, dsigns, reg_enable=False)
    assert mine.refactor(Ax) and ref.refactor(Ax)
    b = rng.standard_normal(N)
    x = mine.solve(b)
    assert np.abs(K @ x - b).max() < 1e-8
    assert _rel(x, ref.solve(b)) < TOL


def test_batch_matches_single_factorizations():
    """B = 3 value sets over one pattern in one factorization equal three
    single ones."""
    rng = np.random.default_rng(5)
    K, dsigns = _kkt_sparse(rng, 30, 35)
    N = 65
    Ap, Ai, Ax = _upper_csc(K)
    Axs = np.stack([Ax * rng.uniform(0.8, 1.25, Ax.shape[0])
                    for _ in range(3)])
    bs = rng.standard_normal((3, N))
    mine = SparseDeviceLDL(N, Ap, Ai, dsigns, reg_enable=False, max_width=8,
                           device="cpu")
    assert mine.refactor(Axs).all()
    xb = mine.solve(bs)
    assert xb.shape == (3, N)
    for i in range(3):
        assert mine.refactor(Axs[i])
        assert _rel(xb[i], mine.solve(bs[i])) < 1e-13


def test_float32_fronts():
    rng = np.random.default_rng(6)
    K, dsigns = _kkt_sparse(rng, 15, 20)
    N = 35
    Ap, Ai, Ax = _upper_csc(K)
    mine = SparseDeviceLDL(N, Ap, Ai, dsigns, reg_enable=False,
                           device="cpu", dtype=torch.float32)
    assert mine.refactor(Ax)
    assert mine._fac["fronts"][0].dtype == torch.float32
    b = rng.standard_normal(N)
    assert _rel(mine.solve(b), np.linalg.solve(K.toarray(), b)) < 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_plans_sum_every_entry(seed):
    """Scatter and SegmentSum add every entry into its target, repeated
    targets included (the dense row's thousands, the fronts' few)."""
    rng = np.random.default_rng(seed)
    idx = np.concatenate([rng.integers(0, 50, 400), np.full(3000, 7)])
    rng.shuffle(idx)
    vals = rng.standard_normal((2, idx.size))
    want = np.zeros((2, 50))
    for i in range(2):
        np.add.at(want[i], idx, vals[i])
    got = Scatter(idx, "cpu").add_(torch.zeros(2, 50, dtype=torch.float64),
                                   torch.as_tensor(vals)).numpy()
    assert _rel(got, want) < 1e-14
    seg = SegmentSum(idx, 50, "cpu")
    assert len(seg.stages) >= 3
    assert _rel(seg(torch.as_tensor(vals)).numpy(), want) < 1e-14
    empty = SegmentSum(np.zeros(0, dtype=np.int64), 4, "cpu")
    assert empty(torch.zeros(2, 0, dtype=torch.float64)).shape == (2, 4)
