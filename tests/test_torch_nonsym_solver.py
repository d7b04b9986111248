"""The port's Solver (device="cpu") on problems with exponential, power
and generalised power cones, against the reference's Solver on the same
numpy data: the goldens of tests/test_basic_exp.py and
tests/test_basic_pow.py (pow and genpow), and problem 0 of
`problems.exp_logistic(4, 10, 1, 5)`, the reference suite's
`exp_logistic(4, 10, 5)` (n = 34, m = 70: KKT dimension 104).

Under kkt_solve_method="lu" on both sides: the same status, iterations
and terminal scaling strategy, and the same iterates to 1e-9 after four
iterations.  The final objectives are held to 1e-8 relative and the
final x to five times the reference's own spread: these problems
amplify rounding from one iteration to the next, so the last iterate of
a solve moves with the last bit of its data.  The reference itself,
given q with one entry moved by one ulp, ends 6.7e-10 (pow), 8.9e-10
(exp) and 2.7e-10 (exp_logistic) apart in objective and up to 1.6e-4,
9.5e-5, 4.6e-3 and 1.1e-9 (genpow) apart in x; the port under "lu" ends
3.0e-9, 5.3e-10 and 3.4e-10 apart from the reference in objective and
1.3e-4, 8.6e-5, 3.7e-3 and 4.8e-10 in x.
Under the defaults (the port's "pallas", its plain LDL^T on the CPU)
against the reference's interpret-mode "pallas" (basic_exp, N = 14):
iterations within one, objective within 1e-8 relative."""

import numpy as np
import pytest

import cuclarabel_tpu as cc
import cuclarabel_torch as ct
from cuclarabel_torch import interop
from cuclarabel_torch.problems import exp_logistic
from tests.test_basic_exp import basic_exp_data
from tests.test_basic_pow import basic_genpow_data, basic_pow_data

TOL_OBJ = 1e-8
TOL_PATH = 1e-9
PATH_ITERS = 4
X_SPREADS = 5.0    # final x vs the reference: this many times its spread
ULP_MOVES = 3      # one-ulp moves of q that measure the spread


def _exp_logistic():
    P, q, A, b, cones = exp_logistic(4, 10, 1, 5)
    return (P, q[0], A[0], b[0],
            [cc.NonnegativeConeT(10)] + [cc.ExponentialConeT()] * 20)


PROBLEMS = {
    "exp": basic_exp_data,
    "pow": basic_pow_data,
    "genpow": basic_genpow_data,
    "exp_logistic": _exp_logistic,
}


def _data(name):
    P, q, A, b, cones = PROBLEMS[name]()
    return P, q, A, b, cones


def _port(name, **kw):
    P, q, A, b, cones = _data(name)
    return ct.Solver(P, q, A, b, interop.cones_from_reference(cones),
                     device="cpu", **kw)


def _ref(name, **kw):
    return cc.Solver(*_data(name), **kw)


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name in PROBLEMS:
        solver = _ref(name, kkt_solve_method="lu")
        out[name] = (solver.solve(), solver.get_info()["scaling"])
    return out


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def _x_spread(name, want):
    """The largest move of the reference's final x when one nonzero
    entry of q moves by one ulp, over the first ULP_MOVES of them."""
    P, q, A, b, cones = _data(name)
    spread = 0.0
    for j in np.flatnonzero(q)[:ULP_MOVES]:
        q1 = q.copy()
        q1[j] = np.nextafter(q[j], np.inf)
        moved = cc.Solver(P, q1, A, b, cones, kkt_solve_method="lu").solve()
        spread = max(spread, float(np.abs(moved.x - want.x).max()))
    return spread


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_lu_matches_reference(reference, name):
    want, want_scaling = reference[name]
    solver = _port(name, kkt_solve_method="lu")
    got = solver.solve()
    assert got.status == want.status == cc.SolverStatus.SOLVED
    assert got.iterations == want.iterations
    assert int(solver.get_info()["scaling"]) == int(want_scaling)
    assert _rel(got.obj_val, want.obj_val) < TOL_OBJ
    spread = _x_spread(name, want)
    assert spread > 0.0
    assert np.abs(got.x - want.x).max() <= X_SPREADS * spread


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_lu_path_matches_reference(name):
    """The first iterations on both sides, where rounding has not grown
    yet: x, s and z within 1e-9 relative to the largest entry."""
    want = _ref(name, kkt_solve_method="lu", max_iter=PATH_ITERS).solve()
    got = _port(name, kkt_solve_method="lu", max_iter=PATH_ITERS).solve()
    assert got.iterations == want.iterations == PATH_ITERS
    assert got.status == want.status
    for f in ("x", "s", "z"):
        g, w = getattr(got, f), getattr(want, f)
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= TOL_PATH * scale, f


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_default_solves(reference, name):
    """The port's default ("pallas": the plain LDL^T kernels on the CPU)
    against the reference's "lu"."""
    want, _ = reference[name]
    solver = _port(name)
    got = solver.solve()
    assert solver.get_info()["linear_solver"]["method"] == "pallas"
    assert got.status == cc.SolverStatus.SOLVED
    assert abs(got.iterations - want.iterations) <= 1
    assert _rel(got.obj_val, want.obj_val) < TOL_OBJ
    assert np.isfinite(got.x).all() and np.isfinite(got.z).all()


def test_pallas_matches_reference_interpret_mode():
    """Port "pallas" (plain) against the reference's "pallas" in
    interpret mode on basic_exp (N = 14, within ROADMAP F3's bounds)."""
    want = _ref("exp", kkt_solve_method="pallas").solve()
    got = _port("exp", kkt_solve_method="pallas").solve()
    assert got.status == want.status == cc.SolverStatus.SOLVED
    assert abs(got.iterations - want.iterations) <= 1
    assert _rel(got.obj_val, want.obj_val) < TOL_OBJ


def test_goldens():
    """The goldens' own bars (tests/test_basic_exp.py,
    tests/test_basic_pow.py) and the suite's exp-logistic-10x4 row
    (benchmarks/ab_results/suite_r05.json: SOLVED in 13 iterations,
    objective -37.901018474810364)."""
    sol = _port("exp").solve()
    x_ref = [-9.425995201329599, 4.828561507482018, 14.59743362204262,
             1.0000012112102774, 7.65314081561849, -29.99999978458479, 0.0]
    assert np.linalg.norm(sol.x - x_ref) < 1e-3
    assert abs(sol.obj_val - (-54.41243965302268)) < 1e-3
    for name in ("pow", "genpow"):
        sol = _port(name).solve()
        assert sol.status == ct.SolverStatus.SOLVED
        assert abs(sol.obj_val - (-1.8458)) < 1e-3
    sol = _port("exp_logistic").solve()
    assert sol.status == ct.SolverStatus.SOLVED
    assert abs(sol.iterations - 13) <= 1  # another factor's rounding
    assert _rel(sol.obj_val, -37.901018474810364) < TOL_OBJ


def test_nonsymmetric_settings_paths():
    """Settings the ladder reads: the Gondzio correctors are off for
    nonsymmetric cones (reference loop.py:727-729), so centrality
    correctors leave the solve unchanged; genpow layouts start and stay
    under Dual scaling; warm starts are refused, as in the reference
    (warmstart.py:21-22)."""
    base = _port("exp").solve()
    corr = _port("exp", centrality_correctors=2).solve()
    assert corr.iterations == base.iterations
    np.testing.assert_array_equal(corr.x, base.x)
    solver = _port("genpow")
    solver.solve()
    assert int(solver.get_info()["scaling"]) == 1
    solver = _port("exp")
    sol = solver.solve()
    with pytest.raises(ValueError):
        solver.solve(warm_start=(sol.x, sol.s, sol.z))
