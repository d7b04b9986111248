"""The port's batch front end (cuclarabel_torch.BatchSolver, device="cpu")
against the reference's (cuclarabel_tpu.parallel.BatchSolver, whose
"auto" KKT method is "lu" on the CPU) on the same numpy problems.

Bars: the same status; objective within 1e-7 relative; x, s and z
within 1e-5 relative to the largest entry (floor 1); iterations within
one (the port's "pallas" path factors another matrix than the
reference's LU, so the last iterate may differ by one step).  Port "lu"
against reference "lu" must take the same iterations.  Batches are held
against per-problem solves, never against a CPU-vmapped reference at
B = 4 (ROADMAP F2)."""

import numpy as np
import pytest

import cuclarabel_tpu as cc
from cuclarabel_tpu.parallel import BatchSolver as RefBatchSolver
from __graft_entry__ import _portfolio_socp
import cuclarabel_torch as ct
from cuclarabel_torch import interop
from cuclarabel_torch.problems import portfolio_socp

B = 3
TOL_OBJ = 1e-7
TOL_VEC = 1e-5


def _lp(mod, rng):
    """Golden LP of tests/test_basic_lp.py with q perturbed per problem."""
    A = np.vstack([np.eye(3), -np.eye(3)]) * 2.0
    q = np.array([3.0, -2.0, 1.0]) + 0.1 * rng.standard_normal((B, 3))
    b = np.ones((B, 6))
    return None, q, A, b, [mod.NonnegativeConeT(3), mod.NonnegativeConeT(3)]


def _qp(mod, rng):
    """Golden QP of tests/test_basic_qp.py with q perturbed per problem
    (problem 0 keeps the golden data)."""
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A0 = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    A = np.vstack([-A0, A0])
    q = np.ones((B, 2)) + 0.2 * rng.standard_normal((B, 2))
    q[0] = 1.0
    b = np.tile(np.concatenate([-np.array([1.0, 0.0, 0.0]),
                                np.array([1.0, 0.7, 0.7])]), (B, 1))
    return P, q, A, b, [mod.NonnegativeConeT(3), mod.NonnegativeConeT(3)]


def _socp(mod, rng):
    if mod is cc:
        A, q, b, cones = _portfolio_socp(nass=4, batch=B, seed=3)
    else:
        A, q, b, cones = portfolio_socp(nass=4, batch=B, seed=3)
    return None, q, A, b, cones


def _mixed_lp(mod, rng):
    """LP batch of a feasible, a primal infeasible and a dual infeasible
    problem (tests/test_basic_lp.py)."""
    A1 = np.vstack([np.eye(3), -np.eye(3)]) * 2.0
    A = np.stack([A1, A1, A1])
    A[2, 3, 0] = 2.0  # the lower bound on x0 becomes a second upper bound
    b = np.ones((B, 6))
    b[1, 0] = b[1, 3] = -1.0
    q = np.tile([3.0, -2.0, 1.0], (B, 1))
    return None, q, A, b, [mod.NonnegativeConeT(3), mod.NonnegativeConeT(3)]


PROBLEMS = {"socp": _socp, "lp": _lp, "qp": _qp, "mixed_lp": _mixed_lp}


def _data(name, mod):
    return PROBLEMS[name](mod, np.random.default_rng(11))


@pytest.fixture(scope="module")
def reference():
    """Reference batch solutions, one solve per problem family."""
    return {name: RefBatchSolver(*_data(name, cc)).solve()
            for name in PROBLEMS}


def _port(name, **kw):
    solver = ct.BatchSolver(*_data(name, ct), device="cpu", **kw)
    return solver, solver.solve()


def _vec_close(a, b):
    return np.abs(a - b).max() <= TOL_VEC * max(np.abs(b).max(), 1.0)


def test_port_data_is_reference_data():
    for name in PROBLEMS:
        for got, want in zip(_data(name, ct)[:4], _data(name, cc)[:4]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["socp", "lp", "qp"])
def test_pallas_matches_reference(reference, name):
    _, sols = _port(name, kkt_solve_method="pallas")
    for got, want in zip(sols, reference[name]):
        assert want.status == cc.SolverStatus.SOLVED
        assert got.status.name == want.status.name
        assert abs(got.obj_val - want.obj_val) <= TOL_OBJ * abs(want.obj_val)
        for f in ("x", "s", "z"):
            assert _vec_close(getattr(got, f), getattr(want, f)), f
        assert abs(got.iterations - want.iterations) <= 1


@pytest.mark.parametrize("name", ["socp", "lp", "qp", "mixed_lp"])
def test_lu_iterations_equal_reference(reference, name):
    _, sols = _port(name, kkt_solve_method="lu")
    for got, want in zip(sols, reference[name]):
        assert got.status.name == want.status.name
        assert got.iterations == want.iterations


def test_mixed_statuses_match_reference(reference):
    _, sols = _port("mixed_lp", kkt_solve_method="pallas")
    want = [s.status.name for s in reference["mixed_lp"]]
    assert want == ["SOLVED", "PRIMAL_INFEASIBLE", "DUAL_INFEASIBLE"]
    assert [s.status.name for s in sols] == want
    assert np.isnan(sols[1].obj_val) and np.isnan(sols[2].obj_val)


@pytest.mark.parametrize("name", ["socp", "qp", "mixed_lp"])
def test_batch_equals_single_solves(name):
    """Each problem of a batch gets the result of solving it alone: a
    finished problem stays frozen while the others iterate."""
    P, q, A, b, cones = _data(name, ct)
    batch = ct.BatchSolver(P, q, A, b, cones, device="cpu").solve()
    for i, got in enumerate(batch):
        Ai = A[i:i + 1] if A.ndim == 3 else A
        one = ct.BatchSolver(P, q[i:i + 1], Ai, b[i:i + 1], cones,
                             device="cpu").solve()[0]
        assert got.status == one.status
        assert got.iterations == one.iterations
        for f in ("x", "s", "z"):
            np.testing.assert_allclose(getattr(got, f), getattr(one, f),
                                       rtol=1e-12, atol=1e-14)


def test_qp_golden():
    """BASELINE.md: x* = [0.3, 0.7], objective 1.8800000298331538
    (reference test/OptTests/basic_qp.jl:64-75), at the accuracy of
    tests/test_basic_qp.py::test_high_accuracy."""
    _, sols = _port("qp")
    sol = sols[0]
    assert sol.status == ct.SolverStatus.SOLVED
    assert np.linalg.norm(sol.x - np.array([0.3, 0.7])) < 1e-6
    assert abs(sol.obj_val - 1.8800000298331538) < 1e-6
    assert sol.r_prim < 1e-8 and sol.r_dual < 1e-8


def test_chunked_batch_equals_unchunked():
    P, q, A, b, cones = _data("socp", ct)
    whole = ct.BatchSolver(P, q, A, b, cones, device="cpu").solve()
    chunked = ct.BatchSolver(P, q, A, b, cones, device="cpu",
                             batch_chunk_size=2).solve()
    for u, c in zip(whole, chunked):
        assert u.iterations == c.iterations
        np.testing.assert_array_equal(u.x, c.x)


def test_update_data_resolves():
    solver, sols = _port("socp")
    _, q, _, _, _ = _data("socp", ct)
    solver.update_data(q=q * 1.5)
    again = solver.solve()
    assert all(s.status == ct.SolverStatus.SOLVED for s in again)
    assert not np.allclose([s.obj_val for s in sols],
                           [s.obj_val for s in again])
    with pytest.raises(ValueError):
        solver.update_data(P=np.eye(solver.n))


def test_unported_options_raise():
    """n_devices = 2, which raised before it was ported: each slab of the
    socp batch (B = 3 is uneven, so a 4th problem joins it: slabs of 2)
    bitwise equal to a one-device batch of that slab, and the options
    the data-parallel batch refuses still raise ValueError."""
    P, q, A, b, cones = _data("socp", ct)
    q4, b4 = np.vstack([q, q[:1] * 1.1]), np.vstack([b, b[:1]])
    got = ct.BatchSolver(P, q4, A, b4, cones, device="cpu",
                         n_devices=2).solve()
    for i in (0, 2):
        one = ct.BatchSolver(P, q4[i:i + 2], A, b4[i:i + 2], cones,
                             device="cpu").solve()
        for g, w in zip(got[i:i + 2], one):
            assert g.status == w.status == ct.SolverStatus.SOLVED
            assert g.iterations == w.iterations
            for f in ("x", "s", "z"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    with pytest.raises(ValueError, match="divide evenly"):
        ct.BatchSolver(P, q, A, b, cones, device="cpu", n_devices=2)
    with pytest.raises(ValueError, match="batch_compaction"):
        ct.BatchSolver(P, q4, A, b4, cones, device="cpu", n_devices=2,
                       batch_compaction=0.9)


def test_exponential_cone_batch_matches_reference():
    """The exponential cone, which raised before it was ported: the exp
    batch of tests/test_batch_sharding.py::test_batch_exp_matches_single
    at B = 3 against the reference's BatchSolver (B != 4: ROADMAP F2),
    both under "lu": the same statuses and iterations, objectives within
    1e-7 relative."""
    c = np.array([-1.0, 0.0, 0.5])
    A = np.vstack([np.array([[0.0, 1.0, 0.0]]),
                   np.array([[0.0, 0.0, 1.0]]), -np.eye(3)])
    bs = np.stack([np.concatenate([[1.0], [1.5 + 0.8 * i], np.zeros(3)])
                   for i in range(B)])
    qs = np.tile(c, (B, 1))
    want = RefBatchSolver(None, qs, A, bs, [
        cc.ZeroConeT(1), cc.NonnegativeConeT(1), cc.ExponentialConeT()],
        kkt_solve_method="lu").solve()
    got = ct.BatchSolver(None, qs, A, bs, [
        ct.ZeroConeT(1), ct.NonnegativeConeT(1), ct.ExponentialConeT()],
        device="cpu", kkt_solve_method="lu").solve()
    for g, w in zip(got, want):
        assert g.status == w.status == cc.SolverStatus.SOLVED
        assert g.iterations == w.iterations
        assert abs(g.obj_val - w.obj_val) <= TOL_OBJ * abs(w.obj_val)


def test_settings_from_reference():
    import dataclasses

    ref = cc.Settings(max_iter=50, tol_feas=1e-9, kkt_solve_method="lu")
    port = interop.settings_from_reference(dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ct.Settings()) == dataclasses.asdict(
        cc.Settings())


def test_problem_from_numpy_reads_the_upper_triangle():
    P = np.array([[4.0, 1.0], [0.0, 2.0]])  # upper triangle only
    prob = interop.problem_from_numpy(
        P, np.ones((2, 2)), np.eye(2), np.ones((2, 2)),
        [ct.NonnegativeConeT(1), ct.NonnegativeConeT(1)])
    assert prob["P"].shape == (2, 2, 2)
    np.testing.assert_array_equal(prob["P"][1], [[4.0, 1.0], [1.0, 2.0]])
    assert prob["cones"] == [ct.NonnegativeConeT(2)]  # collapsed


@pytest.fixture(scope="module")
def reference_correctors():
    return RefBatchSolver(*_data("socp", cc), centrality_correctors=2).solve()


@pytest.mark.parametrize("method", ["pallas", "lu"])
def test_correctors_match_reference(reference_correctors, method):
    """The optional Gondzio correctors (reference loop.py:720-770)."""
    _, sols = _port("socp", kkt_solve_method=method, centrality_correctors=2)
    for got, want in zip(sols, reference_correctors):
        assert got.status == want.status == cc.SolverStatus.SOLVED
        assert abs(got.obj_val - want.obj_val) <= TOL_OBJ * abs(want.obj_val)
        if method == "lu":
            assert got.iterations == want.iterations
        else:
            assert abs(got.iterations - want.iterations) <= 1


def test_time_limit_gives_max_time():
    """tests/test_time_limit.py::test_max_time_batched on the port."""
    sols = ct.BatchSolver(*_data("qp", ct), device="cpu",
                          time_limit=1e-9).solve()
    assert all(s.status == ct.SolverStatus.MAX_TIME for s in sols)
    assert all(s.iterations == 0 for s in sols)


def test_pair_solve_in_the_loop(reference):
    """kkt_pair_solve=True solves the constant and affine systems of an
    iteration in one 2-RHS call (reference loop.py:672-681)."""
    _, sols = _port("socp", kkt_solve_method="pallas", kkt_pair_solve=True)
    for got, want in zip(sols, reference["socp"]):
        assert got.status == want.status == cc.SolverStatus.SOLVED
        assert abs(got.obj_val - want.obj_val) <= TOL_OBJ * abs(want.obj_val)
        assert abs(got.iterations - want.iterations) <= 1
