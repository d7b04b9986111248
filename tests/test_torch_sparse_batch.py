"""The port's BatchSparseSolver (device="cpu") against single solves of
the reference's SparseSolver, problem by problem.

The reference's own batch is never the yardstick here: its CPU-vmapped
batch at B = 4 meets XLA:CPU's miscompile (ROADMAP F2), so every batch
problem is held to a reference SparseSolver solve of that problem
alone: equal status, equal iterations, x within 1e-7 and the objective
within 1e-7 relative.  Families (tests/test_sparse_batch.py's): the
k = 8 grid QP with q and b varying (B = 5), per-problem P values
(k = 6, B = 4, also checked against the scenario's own KKT residual),
an SOCP (rectified equilibration), PSD blocks, and update_data; the
device equilibration against the host one; n_devices = 2."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cuclarabel_tpu.settings import Settings as RefSettings
from cuclarabel_tpu.sparse_solver import SparseSolver as RefSparseSolver
from cuclarabel_tpu.sparse_solver import (
    sparse_ruiz_equilibrate as ref_equilibrate)
import cuclarabel_torch as ct
from cuclarabel_torch.cones.layout import build_layout
from cuclarabel_torch.interop import cones_from_reference
from cuclarabel_torch.kkt.sparse_tpu import SparseProblem, make_sparse_tpu_kkt
from cuclarabel_torch.parallel.sparse_batch import (
    _EquilibrationMaps, device_sparse_equilibrate)
from tests.test_sparse_batch import _grid_family

TOL_X = 1e-7


def _single(P, q, A, b, cones):
    return RefSparseSolver(P, q, A, b, cones,
                           RefSettings(presolve_enable=False)).solve()


def _hold(got, want):
    assert got.status == want.status
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=TOL_X)
    assert abs(got.obj_val - want.obj_val) <= 1e-7 * max(1.0,
                                                         abs(want.obj_val))


def _batch(P, qs, A, bs, cones, **kw):
    return ct.BatchSparseSolver(P, qs, A, bs, cones_from_reference(cones),
                                device="cpu", **kw)


def test_batch_matches_single_qb_only():
    P, qs, A, bs, cones, _, _ = _grid_family(k=8, B=5, seed=0)
    sols = _batch(P, qs, A, bs, cones).solve()
    for i, s in enumerate(sols):
        assert s.status == ct.SolverStatus.SOLVED
        _hold(s, _single(P, qs[i], A, bs[i], cones))


def test_batch_varying_matrix_values():
    P, qs, A, bs, cones, P_vals, A_vals = _grid_family(
        k=6, B=4, seed=1, vary_values=True)
    sols = _batch(P, qs, A, bs, cones, P_vals=P_vals,
                  A_vals=A_vals).solve()
    spp = SparseProblem.from_scipy(P, A)
    n = qs.shape[1]
    for i, s in enumerate(sols):
        assert s.status == ct.SolverStatus.SOLVED
        Pu = sp.coo_matrix((P_vals[i], (spp.P_rows, spp.P_cols)),
                           shape=(n, n)).tocsc()
        _hold(s, _single(Pu, qs[i], A, bs[i], cones))
        Pi = Pu + sp.triu(Pu, 1).T
        rdual = np.abs(Pi @ s.x + qs[i] + A.T @ s.z).max()
        rprim = np.abs(A @ s.x + s.s - bs[i]).max()
        scale = max(1.0, np.abs(bs[i]).max())
        assert rprim / scale < 1e-8 and rdual / scale < 1e-8


def test_batch_sparse_socp():
    from cuclarabel_tpu.cones import api

    rng = np.random.default_rng(3)
    B, n = 4, 12
    P = sp.eye(n).tocsc()
    qs = rng.standard_normal((B, n))
    A = sp.vstack([sp.csr_matrix(np.ones((1, n))), sp.csr_matrix((1, n)),
                   -sp.eye(n)]).tocsc()
    bs = np.tile(np.concatenate([[1.0], [2.0], np.zeros(n)]), (B, 1))
    cones = [api.ZeroConeT(1), api.SecondOrderConeT(n + 1)]
    for i, s in enumerate(_batch(P, qs, A, bs, cones).solve()):
        assert s.status == ct.SolverStatus.SOLVED
        _hold(s, _single(P, qs[i], A, bs[i], cones))


def test_batch_sparse_sdp_blocks():
    from cuclarabel_tpu.cones import api

    rng = np.random.default_rng(9)
    B, sd = 3, 3
    n = 2 * sd
    tr = np.array([1.0, 0.0, 1.0])
    Aeq = np.zeros((2, n))
    Aeq[0, :sd] = tr
    Aeq[1, sd:] = tr
    A = sp.csc_matrix(np.vstack([Aeq, -np.eye(n)]))
    bs = np.tile(np.concatenate([[1.0, 1.0], np.zeros(n)]), (B, 1))
    qs = np.concatenate([np.tile([1.0, 0.3, 1.5], (B, 1)),
                         np.tile([2.0, -0.2, 0.7], (B, 1))], axis=1
                        ) + 0.05 * rng.standard_normal((B, n))
    cones = [api.ZeroConeT(2), api.PSDTriangleConeT(2),
             api.PSDTriangleConeT(2)]
    for i, s in enumerate(_batch(None, qs, A, bs, cones).solve()):
        assert s.status == ct.SolverStatus.SOLVED
        _hold(s, _single(None, qs[i], A, bs[i], cones))


def test_batch_update_data_resolves():
    P, qs, A, bs, cones, _, _ = _grid_family(k=6, B=3, seed=4)
    batch = _batch(P, qs, A, bs, cones)
    first = batch.solve()
    memo = dict(batch._sp._kkt_memo)
    batch.update_data(q=qs * 2.0)
    second = batch.solve()
    assert all(batch._sp._kkt_memo[k] is memo[k] for k in memo)
    for i in range(3):
        _hold(second[i], _single(P, qs[i] * 2.0, A, bs[i], cones))
        assert second[i].obj_val != pytest.approx(first[i].obj_val,
                                                  abs=1e-9)
    with pytest.raises(ValueError, match="shape"):
        batch.update_data(q=qs[:2])


def test_warm_start():
    P, qs, A, bs, cones, _, _ = _grid_family(k=6, B=3, seed=5)
    batch = _batch(P, qs, A, bs, cones)
    cold = batch.solve()
    batch.update_data(q=qs * 1.01)
    warm = batch.solve(warm_start=tuple(
        np.stack([getattr(s, f) for s in cold]) for f in ("x", "s", "z")))
    for i, s in enumerate(warm):
        ref = RefSparseSolver(P, qs[i], A, bs[i], cones,
                              RefSettings(presolve_enable=False))
        rc = ref.solve()
        ref.update_q(qs[i] * 1.01)
        _hold(s, ref.solve(warm_start=(rc.x, rc.s, rc.z)))


def test_device_equilibration_matches_host():
    """device_sparse_equilibrate over a batch equals the host's sparse
    Ruiz (the reference's) problem by problem, to rounding."""
    P, qs, A, bs, cones, P_vals, _ = _grid_family(k=5, B=3, seed=7,
                                                  vary_values=True)
    pcones = cones_from_reference(cones)
    layout = build_layout(tuple(pcones))
    spp = SparseProblem.from_scipy(P, A)
    n, m = qs.shape[1], bs.shape[1]
    st = ct.Settings()
    _, _, host_bufs = make_sparse_tpu_kkt(n, m, st, layout, spp, device="cpu")
    maps = _EquilibrationMaps(host_bufs, spp, layout, "cpu")
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))  # noqa
    Av = np.tile(spp.A_vals(A), (3, 1))
    out = device_sparse_equilibrate(t(P_vals), t(Av), t(qs), t(bs), maps,
                                    n, m, st)
    from cuclarabel_tpu.cones.layout import build_layout as ref_layout

    for i in range(3):
        Pu = sp.coo_matrix((P_vals[i], (spp.P_rows, spp.P_cols)),
                           shape=(n, n)).tocsc()
        _, _, qh, bh, d, e, c = ref_equilibrate(
            Pu, A, qs[i], bs[i], ref_layout(tuple(cones)), RefSettings())
        np.testing.assert_allclose(out["d"][i].numpy(), d, rtol=1e-13)
        np.testing.assert_allclose(out["e"][i].numpy(), e, rtol=1e-13)
        np.testing.assert_allclose(float(out["cscale"][i]), c, rtol=1e-13)
        np.testing.assert_allclose(out["q"][i].numpy(), qh, rtol=1e-13)
        np.testing.assert_allclose(out["b"][i].numpy(), bh, rtol=1e-13)


def test_n_devices_above_one_raises():
    """n_devices = 2, which raised before it was ported: each problem
    with the statuses, iterations and x of its single reference solve,
    and bitwise equal to a one-device batch of its slab; an uneven batch
    and values of the wrong shape still raise ValueError."""
    P, qs, A, bs, cones, _, _ = _grid_family(k=4, B=2, seed=2)
    got = _batch(P, qs, A, bs, cones, n_devices=2).solve()
    for i, s in enumerate(got):
        _hold(s, _single(P, qs[i], A, bs[i], cones))
        one = _batch(P, qs[i:i + 1], A, bs[i:i + 1], cones).solve()[0]
        assert s.iterations == one.iterations
        for f in ("x", "s", "z"):
            np.testing.assert_array_equal(getattr(s, f), getattr(one, f))
    with pytest.raises(ValueError, match="divide evenly"):
        _batch(P, qs[:1], A, bs[:1], cones, n_devices=2)
    with pytest.raises(ValueError, match="P_vals"):
        _batch(P, qs, A, bs, cones, P_vals=np.ones((2, 3)))
