"""The port's "pallas" path above N = 128 on the CPU: the portfolio SOCP at
nass = 64 (n = 65, m = 83, KKT dimension N = 148), where the card runs
the LDL^T kernels' wide forms (csrc/ldl_wide.cu) and the CPU their plain
versions, against the reference's solves under "lu" on the same numpy
problems.

Bars (tests/test_torch_batch.py's): the same status, iterations within
one (the port factors the scaled, permuted K without pivoting, the
reference's LU with pivoting), x within 1e-7 relative to its largest
entry (floor 1), objective within 1e-7 relative.  B = 3: never a
reference batch of 4 (ROADMAP F2)."""

import numpy as np
import pytest

import cuclarabel_tpu as cc
from cuclarabel_tpu.parallel import BatchSolver as RefBatchSolver
from __graft_entry__ import _portfolio_socp
import cuclarabel_torch as ct
from cuclarabel_torch.kkt import ldl
from cuclarabel_torch.problems import portfolio_socp

NASS, B, SEED = 64, 3, 7
TOL_X = 1e-7
TOL_OBJ = 1e-7


def _close(got, want):
    assert got.status.name == want.status.name == "SOLVED"
    assert abs(got.iterations - want.iterations) <= 1
    assert (np.abs(got.x - want.x).max()
            <= TOL_X * max(np.abs(want.x).max(), 1.0))
    assert abs(got.obj_val - want.obj_val) <= TOL_OBJ * abs(want.obj_val)


@pytest.fixture(scope="module")
def data():
    port = portfolio_socp(NASS, B, seed=SEED)
    ref = _portfolio_socp(NASS, B, seed=SEED)
    for got, want in zip(port[:3], ref[:3]):
        np.testing.assert_array_equal(got, want)
    return port, ref


def test_batch_pallas_above_128_matches_reference(data):
    (A, qs, bs, cones), (Ar, qr, br, rcones) = data
    ldl.reset_counts()
    solver = ct.BatchSolver(None, qs, A, bs, cones, device="cpu",
                            kkt_solve_method="pallas")
    sols = solver.solve()
    assert solver.n + solver.m == 148
    assert not ldl.LAUNCHES
    assert ldl.PLAIN_CALLS["ldl_factor/r1"] > 0
    assert ldl.PLAIN_CALLS["ldl_solve_refine/r1"] > 0
    ref = RefBatchSolver(None, qr, Ar, br, rcones,
                         kkt_solve_method="lu").solve()
    for got, want in zip(sols, ref):
        _close(got, want)


def test_solver_pallas_above_128_matches_reference(data):
    (A, qs, bs, cones), (Ar, qr, br, rcones) = data
    ldl.reset_counts()
    solver = ct.Solver(None, qs[0], A, bs[0], cones, device="cpu",
                       kkt_solve_method="pallas")
    got = solver.solve()
    assert solver.get_info()["linear_solver"]["method"] == "pallas"
    assert not ldl.LAUNCHES
    assert ldl.PLAIN_CALLS["ldl_factor/r1"] >= got.iterations
    assert ldl.PLAIN_CALLS["ldl_solve_refine/r1"] > 0
    want = cc.Solver(None, qr[0], Ar, br[0], rcones,
                     kkt_solve_method="lu").solve()
    _close(got, want)
