"""The port's SparseSolver (device="cpu") against the reference's
SparseSolver, on every problem of tests/test_sparse_solver.py, and the
port's Solver(direct_solve_method="qdldl") against the reference's on
the goldens of tests/test_kkt_backends.py.

Each problem is built once from its numpy seed and solved by both:
equal statuses, equal iterations, x within 1e-7 (absolute) and the
objective within 1e-7 relative.  Covered: the grid QP (k = 5 and 14),
an LP, a primal infeasible problem, SOC blocks of dimension <= 4 and
the rank-2 expansion, the exponential cone, the generalised power
cone's rank-3 expansion, PSD blocks, the chordal SDP (decomposed before
the pattern analysis), update_data with the reuse of the symbolic
analysis (the updated solve within 1e-7 of a fresh solver's, as in the
reference test), input_sparse_dropzeros, the presolve round trip, f32
fronts and a warm start."""

import numpy as np
import pytest
import scipy.sparse as sp

import cuclarabel_tpu as cc
from cuclarabel_tpu.sparse_solver import SparseSolver as RefSparseSolver
import cuclarabel_torch as ct
from cuclarabel_torch.interop import cones_from_reference
from cuclarabel_torch.kkt import sparse_tpu
from tests.test_kkt_backends import qp_data, sdp_data, socp_data
from tests.test_sparse_solver import _grid_qp

TOL_X = 1e-7
TOL_OBJ = 1e-7


def _lp():
    rng = np.random.default_rng(1)
    n = 60
    A0 = sp.random(25, n, density=0.2,
                   random_state=np.random.RandomState(2), format="csc")
    x0 = np.abs(rng.standard_normal(n)) + 0.1
    brow = np.asarray(A0 @ x0).ravel() + 1.0
    A = sp.vstack([A0, -sp.eye(n)]).tocsc()
    b = np.concatenate([brow, np.zeros(n)])
    q = rng.random(n)
    return None, q, A, b, [cc.NonnegativeConeT(25), cc.NonnegativeConeT(n)]


def _infeasible():
    n = 10
    A = sp.vstack([sp.eye(n), -sp.eye(n)]).tocsc()
    b = np.concatenate([-np.ones(n), -np.ones(n)])
    return None, np.zeros(n), A, b, [cc.NonnegativeConeT(2 * n)]


def _socp(seed, ng, dim, rhs):
    rng = np.random.default_rng(seed)
    n = 8 if dim == 4 else 10
    G = rng.standard_normal((ng, n)) / (3.0 if dim == 4 else 4.0)
    A = sp.vstack([
        sp.csr_matrix(np.ones((1, n))),
        -sp.eye(n),
        sp.csr_matrix(np.zeros((1, n))),
        sp.csr_matrix(-G),
    ]).tocsc()
    b = np.concatenate([[1.0], np.zeros(n), [rhs], np.zeros(ng)])
    q = -rng.random(n)
    return None, q, A, b, [cc.ZeroConeT(1), cc.NonnegativeConeT(n),
                           cc.SecondOrderConeT(dim)]


def _exp():
    A = sp.vstack([
        sp.csc_matrix(-np.eye(3)),
        sp.csr_matrix(np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])),
    ]).tocsc()
    b = np.concatenate([np.zeros(3), [1.0, float(np.e)]])
    return None, np.array([-1.0, 0.0, 0.0]), A, b, [cc.ExponentialConeT(),
                                                    cc.ZeroConeT(2)]


def _genpow():
    from tests.test_basic_pow import basic_genpow_data

    P, q, A, b, cones = basic_genpow_data()
    return (sp.csc_matrix(P) if P is not None else None, q,
            sp.csc_matrix(A), b, cones)


def _sdp_blocks():
    sd = 3
    n = 2 * sd
    q = np.concatenate([[1.0, 0.3, 1.5], [2.0, -0.2, 0.7]])
    tr_row = np.array([1.0, 0.0, 1.0])
    Aeq = np.zeros((2, n))
    Aeq[0, :sd] = tr_row
    Aeq[1, sd:] = tr_row
    A = sp.csc_matrix(np.vstack([Aeq, -np.eye(n)]))
    b = np.concatenate([[1.0, 1.0], np.zeros(n)])
    return None, q, A, b, [cc.ZeroConeT(2), cc.PSDTriangleConeT(2),
                           cc.PSDTriangleConeT(2)]


def _chordal():
    from tests.test_sdp_chordal import sdp_chordal_data

    P, q, A, b, cones = sdp_chordal_data()
    return sp.csc_matrix(P), q, sp.csc_matrix(A), b, cones


CHORDAL = dict(chordal_decomposition_enable=True,
               chordal_decomposition_compact=True,
               chordal_decomposition_complete_dual=True,
               chordal_decomposition_merge_method="none")

PROBLEMS = {
    "qp_grid5": (lambda: _grid_qp(5), {}),
    "grid14": (lambda: _grid_qp(14, seed=3), {}),
    "lp": (_lp, {}),
    "infeasible": (_infeasible, {}),
    "socp_small_blocks": (lambda: _socp(5, 3, 4, 0.25), {}),
    "socp_rank2": (lambda: _socp(6, 7, 8, 0.4), {}),
    "exp": (_exp, {}),
    "genpow_rank3": (_genpow, {}),
    "sdp_blocks": (_sdp_blocks, {}),
    "sdp_chordal": (_chordal, CHORDAL),
    "dropzeros": (lambda: _grid_qp(4, seed=11),
                  {"input_sparse_dropzeros": True}),
    "f32_fronts": (lambda: _grid_qp(5), {"kkt_factor_precision": "float32"}),
}


def _port(P, q, A, b, cones, **kw):
    return ct.SparseSolver(P, q, A, b, cones_from_reference(cones),
                           device="cpu", **kw)


def _hold(got, want):
    assert got.status == want.status, (got.status, want.status)
    assert got.iterations == want.iterations
    if want.status == cc.SolverStatus.SOLVED:
        np.testing.assert_allclose(got.x, want.x, rtol=0, atol=TOL_X)
        assert abs(got.obj_val - want.obj_val) <= TOL_OBJ * max(
            1.0, abs(want.obj_val))
        assert got.r_prim < 1e-8 and got.r_dual < 1e-8


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_matches_reference(name):
    make, kw = PROBLEMS[name]
    P, q, A, b, cones = make()
    solver = _port(P, q, A, b, cones, **kw)
    got = solver.solve()
    want = RefSparseSolver(P, q, A, b, cones, **kw).solve()
    _hold(got, want)
    if name == "infeasible":
        assert got.status in (ct.SolverStatus.PRIMAL_INFEASIBLE,
                              ct.SolverStatus.ALMOST_PRIMAL_INFEASIBLE)
    if name == "sdp_chordal":
        assert solver.chordal_info is not None
        assert got.s.shape[0] == b.shape[0]
        with pytest.raises(ValueError, match="chordal"):
            solver.update_b(b)
    info = solver.get_info()["linear_solver"]
    assert info["method"] == "multifrontal"
    assert info["kkt_dim"] >= solver.n + solver.m


def test_update_data_reuses_the_analysis():
    """A parametric re-solve: same pattern, new values; the symbolic
    analysis and the device maps are not built again, and the re-solve
    equals a fresh solve of the new data (data_updating.jl semantics)."""
    P, q, A, b, cones = _grid_qp(5, seed=9)
    solver = _port(P, q, A, b, cones)
    solver.solve()
    memo = dict(solver._sp._kkt_memo)
    q2, b2, P2 = q * 2.0 + 0.1, b + 0.05, P * 1.5
    solver.update_data(P=P2, q=q2, b=b2)
    again = solver.solve()
    assert solver._sp._kkt_memo.keys() == memo.keys()
    assert all(solver._sp._kkt_memo[k] is memo[k] for k in memo)
    # a fresh solver equilibrates the new data anew, the updated one
    # keeps its scaling (the reference test's 1e-7)
    fresh = _port(P2, q2, A, b2, cones).solve()
    np.testing.assert_allclose(again.x, fresh.x, rtol=0, atol=TOL_X)
    ref = RefSparseSolver(P, q, A, b, cones)
    ref.solve()
    ref.update_data(P=P2, q=q2, b=b2)
    _hold(again, ref.solve())
    with pytest.raises(ValueError, match="pattern"):
        bad = P.tolil(copy=True)
        bad[0, 3] = 5.0
        solver.update_P(bad.tocsc())


def test_dropzeros_prunes_the_pattern():
    P, q, A, b, cones = _grid_qp(4, seed=11)
    kept = _port(P, q, A, b, cones)._sp.P_rows.shape[0]
    dropped = _port(P, q, A, b, cones,
                    input_sparse_dropzeros=True)._sp.P_rows.shape[0]
    ref = RefSparseSolver(P, q, A, b, cones,
                          input_sparse_dropzeros=True)._sp.P_rows.shape[0]
    assert dropped == ref <= kept


def test_presolve_round_trip():
    P, q, A, b, cones = _grid_qp(5, seed=13)
    b2 = b.copy()
    b2[3] = 1e21  # above INFINITY -> dropped
    solver = _port(P, q, A, b2, cones)
    assert solver.presolver is not None
    sol = solver.solve()
    _hold(sol, RefSparseSolver(P, q, A, b2, cones).solve())
    assert sol.s.shape[0] == b.shape[0]
    assert sol.s[3] == ct.get_infinity() and sol.z[3] == 0.0
    with pytest.raises(ValueError, match="presolver"):
        solver.update_q(q)


def test_f32_fronts_meet_the_f64_bar():
    """kkt_factor_precision="float32" factors the fronts in f32 with f64
    refinement: the default 1e-8 tolerances and x within 1e-6 of the
    f64 fronts' (tests/test_sparse_solver.py:281-292)."""
    P, q, A, b, cones = _grid_qp(5)
    s32 = _port(P, q, A, b, cones, kkt_factor_precision="float32").solve()
    s64 = _port(P, q, A, b, cones).solve()
    assert s32.status == ct.SolverStatus.SOLVED
    assert s32.r_prim < 1e-8 and s32.r_dual < 1e-8
    np.testing.assert_allclose(s32.x, s64.x, atol=1e-6)


def test_warm_start_resolve():
    P, q, A, b, cones = _grid_qp(6, seed=2)
    solver = _port(P, q, A, b, cones)
    cold = solver.solve()
    solver.update_q(1.01 * q)
    warm = solver.solve(warm_start=(cold.x, cold.s, cold.z))
    ref = RefSparseSolver(P, q, A, b, cones)
    rc = ref.solve()
    ref.update_q(1.01 * q)
    _hold(warm, ref.solve(warm_start=(rc.x, rc.s, rc.z)))


def test_verbose_streams_the_table(capsys):
    P, q, A, b, cones = _grid_qp(4)
    _port(P, q, A, b, cones, verbose=True).solve()
    out = capsys.readouterr().out
    assert "sparse multifrontal" in out
    assert out.count("\n") > 10


def test_sparse_path_is_deterministic():
    """Two solves of one problem are bitwise equal (the fixed-order sums
    of kkt/scatter.py)."""
    P, q, A, b, cones = _lp()
    solver = _port(P, q, A, b, cones)
    a, c = solver.solve(), solver.solve()
    np.testing.assert_array_equal(a.x, c.x)
    np.testing.assert_array_equal(a.z, c.z)
    assert a.iterations == c.iterations


def test_the_device_maps_are_built_once():
    P, q, A, b, cones = _grid_qp(4)
    solver = _port(P, q, A, b, cones)
    before = len(solver._sp._kkt_memo)
    fac1, _, _ = sparse_tpu.make_sparse_tpu_kkt(
        solver.n, solver.m, solver.settings, solver.layout, solver._sp,
        device="cpu")
    assert fac1 is solver._factorize
    assert len(solver._sp._kkt_memo) == before


@pytest.mark.parametrize("data", [qp_data, socp_data, sdp_data],
                         ids=["qp", "socp", "sdp"])
def test_qdldl_solver_matches_reference(data):
    P, q, A, b, cones, obj = data()
    got = ct.Solver(P, q, A, b, cones_from_reference(cones), device="cpu",
                    direct_solve_method="qdldl").solve()
    want = cc.Solver(P, q, A, b, cones, direct_solve_method="qdldl").solve()
    lu = ct.Solver(P, q, A, b, cones_from_reference(cones), device="cpu",
                   kkt_solve_method="lu").solve()
    _hold(got, want)
    assert got.iterations == lu.iterations
    assert abs(got.obj_val - obj) < 1e-3


def test_memory_guard_refuses_an_oversized_plan(monkeypatch):
    monkeypatch.setenv("CUCLARABEL_SPARSE_HBM_BUDGET", "1000")
    P, q, A, b, cones = _grid_qp(4)
    with pytest.raises(MemoryError, match="CUDA device"):
        _port(P, q, A, b, cones)
