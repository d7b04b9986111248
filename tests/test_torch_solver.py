"""The port's single-problem Solver (cuclarabel_torch.Solver, device="cpu")
against the reference's (cuclarabel_tpu.Solver, whose "auto" KKT method
is "lu" on the CPU) on the same numpy problems: the golden data of
tests/test_basic_{lp,qp,socp,eq_constrained}.py and the portfolio SOCP at
nass = 32 (N = 76) and nass = 64 (N = 148, past the LDL^T kernels' cap).

Bars: under kkt_solve_method="lu" on both sides the same status and
iterations, the objective within 1e-8 relative, and x, s, z within 1e-8
relative to the largest entry (floor 1): the same algorithm on the same
host-equilibrated data, apart from the rounding of the LU and matrix
products.  The golden SOCP alone is held to 1e-7 in x, s, z: one
refinement pass more in the reference at iteration 5 (a tie of the stop
ratio at rounding level) leaves the final x 1.2e-8 apart; both runs stop
within their 1e-8 tolerances, not on one point.  Under the
defaults (the port's "pallas", the plain LDL^T on the CPU, against the
reference's "lu") iterations within one and x, s, z within 1e-6.  Each
reference solve is made once per module (`reference`)."""

import dataclasses

import numpy as np
import pytest

import cuclarabel_tpu as cc
import cuclarabel_torch as ct
from cuclarabel_torch import interop
from cuclarabel_torch.problems import portfolio_socp
from tests.test_basic_lp import basic_lp_data
from tests.test_basic_qp import basic_qp_data
from tests.test_basic_socp import basic_socp_data

TOL_OBJ = 1e-8
TOL_LU = 1e-8
TOL_LU_SOCP = 1e-7  # the golden SOCP: see the module docstring
TOL_DEFAULT = 1e-6
F32 = dict(kkt_factor_precision="float32", tol_gap_abs=1e-7,
           tol_gap_rel=1e-7, tol_feas=1e-7)  # tests/test_f32_golden.py


def _eq_data():
    """tests/test_basic_eq_constrained.py::test_equality_constrained_2."""
    A = np.array([[1.0, 1.0, 1.0], [0.0, 1.0, -1.0]])
    return (np.eye(3), np.array([1.0, 2.0, 3.0]), A, np.array([2.0, 0.0]),
            [cc.ZeroConeT(2)])


def _lp_primal_infeasible():
    P, q, A, b, cones = basic_lp_data()
    b[0] = b[3] = -1.0
    return P, q, A, b, cones


def _socp_primal_infeasible():
    P, q, A, b, cones = basic_socp_data()
    b[6] = -10.0
    return P, q, A, b, cones


def _qp_presolved():
    """tests/test_misc_opt.py::presolver_test_data with one infinite
    bound: presolve drops row 3 and puts it back."""
    A = np.vstack([np.eye(3), -np.eye(3)]) * 2.0
    b = np.ones(6)
    b[3] = 1e21
    return (np.eye(3), np.array([3.0, -2.0, 1.0]), A, b,
            [cc.NonnegativeConeT(3), cc.NonnegativeConeT(3)])


def _portfolio(nass):
    A, q, b, cones = portfolio_socp(nass, 1, seed=7)
    ref_cones = [getattr(cc, type(c).__name__)(c.dim) for c in cones]
    return None, q[0], A, b[0], ref_cones


PROBLEMS = {
    "lp": basic_lp_data,
    "qp": basic_qp_data,
    "socp": basic_socp_data,
    "eq": _eq_data,
    "lp_pinf": _lp_primal_infeasible,
    "socp_pinf": _socp_primal_infeasible,
    "qp_presolve": _qp_presolved,
    "portfolio32": lambda: _portfolio(32),
    "portfolio64": lambda: _portfolio(64),
}


def _port_cones(cones):
    return [getattr(ct, type(c).__name__)(**dataclasses.asdict(c))
            for c in cones]


def _port(name, **kw):
    P, q, A, b, cones = PROBLEMS[name]()
    return ct.Solver(P, q, A, b, _port_cones(cones), device="cpu", **kw)


@pytest.fixture(scope="module")
def reference():
    """Reference solutions, each solved once: reference(name, **kw)."""
    memo = {}

    def solve(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = cc.Solver(*PROBLEMS[name](), **kw).solve()
        return memo[key]

    return solve


def _tol_lu(name):
    return TOL_LU_SOCP if name == "socp" else TOL_LU


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0)


def _same_result(got, want, tol, tol_obj):
    assert got.status.name == want.status.name
    for f in ("x", "s", "z"):
        assert _close(getattr(got, f), getattr(want, f), tol), f
    if np.isnan(want.obj_val):
        assert np.isnan(got.obj_val) and np.isnan(got.obj_val_dual)
    else:
        assert abs(got.obj_val - want.obj_val) <= tol_obj * max(
            abs(want.obj_val), 1.0)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_lu_matches_reference(reference, name):
    want = reference(name, kkt_solve_method="lu")
    got = _port(name, kkt_solve_method="lu").solve()
    _same_result(got, want, _tol_lu(name), TOL_OBJ)
    assert got.iterations == want.iterations


@pytest.mark.parametrize("name", ["lp", "qp", "socp", "eq", "lp_pinf",
                                  "portfolio32", "portfolio64"])
def test_defaults_match_reference(reference, name):
    want = reference(name)
    solver = _port(name)
    got = solver.solve()
    _same_result(got, want, TOL_DEFAULT, TOL_DEFAULT)
    assert abs(got.iterations - want.iterations) <= 1
    N = solver.n + solver.m
    method = solver.get_info()["linear_solver"]["method"]
    assert method == ("pallas" if N <= 128 else "lu")


def test_goldens():
    """BASELINE.md's QP golden and the goldens of test_basic_{lp,socp}."""
    qp = _port("qp").solve()
    assert np.linalg.norm(qp.x - np.array([0.3, 0.7])) < 1e-6
    assert abs(qp.obj_val - 1.8800000298331538) < 1e-6
    lp = _port("lp").solve()
    assert np.linalg.norm(lp.x - np.array([-0.5, 0.5, -0.5])) < 1e-3
    assert abs(lp.obj_val + 3.0) < 1e-3
    socp = _port("socp").solve()
    assert np.linalg.norm(socp.x - np.array([-0.5, 0.435603, -0.245459])) < 1e-3
    assert abs(socp.obj_val + 0.84590) < 1e-3


def test_presolve_reinserts_rows(reference):
    want = reference("qp_presolve", kkt_solve_method="lu")
    solver = _port("qp_presolve")
    assert solver.m == 5
    got = solver.solve()
    for sol in (got, want):
        assert sol.status.name == "SOLVED"
        assert sol.s.shape == sol.z.shape == (6,)
        assert sol.s[3] == 1e20 and sol.z[3] == 0.0
    assert not solver.is_data_update_allowed()
    with pytest.raises(ValueError):
        solver.update_q(np.ones(3))
    with pytest.raises(ValueError):
        solver.solve(warm_start=(got.x, got.s, got.z))


@pytest.mark.parametrize("name", ["lp_pinf", "socp_pinf"])
def test_primal_infeasible_certificate(name):
    sol = _port(name).solve()
    assert sol.status == ct.SolverStatus.PRIMAL_INFEASIBLE
    assert np.isnan(sol.obj_val) and np.isnan(sol.obj_val_dual)


def _updating_qp():
    """tests/test_data_updating.py::updating_qp."""
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.array([[1.0, 1.0]]), np.eye(2), -np.eye(2)])
    b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    return P, q, A, b, [ct.ZeroConeT(1), ct.NonnegativeConeT(4)]


UPDATES = {
    "q": lambda P, q, A, b: dict(q=q + np.array([0.3, -0.2])),
    "b": lambda P, q, A, b: dict(b=b + 0.1),
    "A": lambda P, q, A, b: dict(A=A + np.array([[0.0, 1.0]] + 4 * [[0, 0]])),
    "P_indexed": lambda P, q, A, b: dict(P=(np.array([0]), np.array([6.0]))),
    "data": lambda P, q, A, b: dict(P=P * 1.5, q=q + np.array([0.3, -0.2]),
                                    b=b + 0.1),
}


@pytest.mark.parametrize("which", list(UPDATES))
def test_update_equals_fresh_solve(which):
    P, q, A, b, cones = _updating_qp()
    solver = ct.Solver(P, q, A, b, cones, device="cpu",
                       presolve_enable=False)
    solver.solve()
    upd = UPDATES[which](P, q, A, b)
    solver.update_data(**upd)
    got = solver.solve()
    if which == "P_indexed":
        P = P.copy()
        P[0, 0] = 6.0
        upd = dict(P=P)
    fresh = dict(dict(P=P, q=q, A=A, b=b), **upd)
    want = ct.Solver(fresh["P"], fresh["q"], fresh["A"], fresh["b"], cones,
                     device="cpu", presolve_enable=False).solve()
    assert got.status == want.status == ct.SolverStatus.SOLVED
    assert abs(got.obj_val - want.obj_val) < 1e-8
    assert np.linalg.norm(got.x - want.x) < 1e-7


def _warm_qp(mod, n=40):
    """tests/test_warm_start.py::_qp."""
    rng = np.random.default_rng(0)
    F = rng.standard_normal((n, 8))
    P = 2 * (F @ F.T + 0.1 * np.eye(n))
    q = -rng.standard_normal(n)
    A = np.vstack([np.ones((1, n)), -np.eye(n), np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n), np.ones(n) * 0.5])
    return P, q, A, b, [mod.ZeroConeT(1), mod.NonnegativeConeT(2 * n)]


def _warm_socp(mod):
    """tests/test_warm_start.py::test_warm_start_socp."""
    rng = np.random.default_rng(2)
    n = 8
    G = rng.standard_normal((5, n)) / 4.0
    q = -rng.random(n)
    A = np.vstack([np.ones((1, n)), -np.eye(n), np.zeros((1, n)), -G])
    b = np.concatenate([[1.0], np.zeros(n), [0.3], np.zeros(5)])
    return None, q, A, b, [mod.ZeroConeT(1), mod.NonnegativeConeT(n),
                           mod.SecondOrderConeT(6)]


def _warm_run(Solver, data, **kw):
    P, q, A, b, cones = data
    s = Solver(P, q, A, b, cones, presolve_enable=False,
               kkt_solve_method="lu", **kw)
    sol = s.solve()
    s.update_q(q + 0.01 * np.random.default_rng(1).standard_normal(len(q)))
    warm = s.solve(warm_start=(sol.x, sol.s, sol.z))
    cold = s.solve()
    return warm, cold


@pytest.mark.parametrize("make", [_warm_qp, _warm_socp], ids=["qp", "socp"])
def test_warm_start_iterations_equal_reference(make):
    warm, cold = _warm_run(ct.Solver, make(ct), device="cpu")
    rwarm, rcold = _warm_run(cc.Solver, make(cc))
    assert warm.status == ct.SolverStatus.SOLVED
    assert warm.iterations == rwarm.iterations
    assert cold.iterations == rcold.iterations
    assert warm.iterations < cold.iterations
    assert abs(warm.obj_val - cold.obj_val) < 1e-7 * max(1, abs(cold.obj_val))
    assert _close(warm.x, rwarm.x, TOL_LU)


def test_warm_start_guards():
    solver = ct.Solver(*_warm_qp(ct, n=6), device="cpu",
                       presolve_enable=False)
    sol = solver.solve()
    with pytest.raises(ValueError):
        solver.solve(warm_start=(sol.x[:-1], sol.s, sol.z))


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_json_round_trip(tmp_path, reference, direction):
    """A problem saved by one package loads into the other and gives the
    same solution (json_io on both sides shares the schema)."""
    path = str(tmp_path / "problem.json")
    name = "socp"
    if direction == "reference_to_port":
        cc.Solver(*PROBLEMS[name](), kkt_solve_method="lu").save_to_file(path)
        loaded = ct.Solver.load_from_file(path, device="cpu")
    else:
        _port(name, kkt_solve_method="lu").save_to_file(path)
        loaded = cc.Solver.load_from_file(path)
    assert loaded.settings.kkt_solve_method == "lu"
    got = loaded.solve()
    want = reference(name, kkt_solve_method="lu")
    _same_result(got, want, _tol_lu(name), TOL_OBJ)
    assert got.iterations == want.iterations


@pytest.mark.parametrize("name,x_star,obj", [
    ("lp", [-0.5, 0.5, -0.5], -3.0),
    ("qp", [0.3, 0.7], 1.8800000298331538),
    ("socp", [-0.5, 0.435603, -0.245459], -0.84590),
])
def test_f32_factor(reference, name, x_star, obj):
    """kkt_factor_precision="float32" under "lu" factors in f32 and
    refines in f64, as the reference does: tests/test_f32_golden.py's
    bars hold, and the result is not the f64 factor's."""
    s32 = _port(name, kkt_solve_method="lu", **F32)
    got = s32.solve()
    assert got.status == ct.SolverStatus.SOLVED
    assert np.linalg.norm(got.x - np.array(x_star)) < 1e-3
    assert abs(got.obj_val - obj) < 1e-3
    assert s32.get_info()["linear_solver"]["factor_precision"] == "float32"
    s64 = _port(name, kkt_solve_method="lu", **dict(
        F32, kkt_factor_precision="float64"))
    f64 = s64.solve()
    assert not np.array_equal(got.x, f64.x)
    # an f32 factor leaves more for the f64 refinement to do
    assert s32.get_info()["ir_count"] > s64.get_info()["ir_count"]
    want = reference(name, kkt_solve_method="lu", **F32)
    assert got.status.name == want.status.name
    assert abs(got.iterations - want.iterations) <= 1


def test_time_limit_gives_max_time():
    """tests/test_time_limit.py::test_max_time_single on the port."""
    sol = _port("qp", time_limit=1e-9).solve()
    assert sol.status == ct.SolverStatus.MAX_TIME
    assert sol.iterations == 0


def test_psd_cone_matches_reference():
    """The PSD triangle cone, which raised before it was ported: the SDP
    golden of tests/test_basic_sdp.py under "lu" on both sides, the same
    status and iterations, the objective within 1e-8 relative
    (tests/test_torch_psd_solver.py holds the rest)."""
    from tests.test_basic_sdp import basic_sdp_data

    P, q, A, b, cones = basic_sdp_data()
    want = cc.Solver(P, q, A, b, cones, kkt_solve_method="lu").solve()
    got = ct.Solver(P, q, A, b, interop.cones_from_reference(cones),
                    device="cpu", kkt_solve_method="lu").solve()
    assert got.status == ct.SolverStatus.SOLVED
    assert got.iterations == want.iterations
    assert abs(got.obj_val - want.obj_val) <= 1e-8 * abs(want.obj_val)


def test_exponential_cone_matches_reference():
    """The exponential cone, which raised before it was ported: the
    golden of tests/test_basic_exp.py under "lu" on both sides, the same
    status and iterations, the objective within 1e-8 relative
    (tests/test_torch_nonsym_solver.py holds the rest)."""
    from tests.test_basic_exp import basic_exp_data

    P, q, A, b, cones = basic_exp_data()
    want = cc.Solver(P, q, A, b, cones, kkt_solve_method="lu").solve()
    got = ct.Solver(P, q, A, b, [ct.ZeroConeT(1), ct.NonnegativeConeT(3),
                                 ct.ExponentialConeT()],
                    kkt_solve_method="lu", device="cpu").solve()
    assert got.status == want.status == cc.SolverStatus.SOLVED
    assert got.iterations == want.iterations
    assert abs(got.obj_val - want.obj_val) <= TOL_OBJ * abs(want.obj_val)


def test_info_surface(reference):
    solver = _port("qp", host_solve="on")
    solver.solve()
    info = solver.get_info()
    solver.print_timers()
    ref = cc.Solver(*PROBLEMS["qp"]())
    ref.solve()
    assert set(info) == set(ref.get_info())
    ls = info["linear_solver"]
    assert ls["host_solve"] is False  # host_solve has no effect in the port
    assert ls["method"] == "pallas" and ls["dd_npass"] == 1
    assert ls["kkt_dim"] == 8 and ls["nnzL"] == 36
    assert set(ls) - {"dd_npass"} == set(ref.get_info()["linear_solver"])


def test_verbose_streams_the_table(capsys):
    sol = _port("qp", verbose=True).solve()
    out = capsys.readouterr().out
    assert "cuclarabel_torch" in out and "Terminated with status" in out
    rows = [ln for ln in out.splitlines() if ln[:3].strip().isdigit()]
    assert [int(r.split()[0]) for r in rows] == list(
        range(sol.iterations + 1))


@pytest.mark.parametrize("method", ["qr", "inverse"])
@pytest.mark.parametrize("name", ["qp", "socp", "lp_pinf", "portfolio32"])
def test_qr_and_inverse_match_reference(reference, name, method):
    """kkt_solve_method "qr" and "inverse" on both sides
    (tests/test_kkt_backends.py:59): the same status and iterations, the
    objective within 1e-8 relative.  The reference's f64 "inverse" is
    pivot-free and the port's pivoted (kkt/dense.py), so x, s and z are
    held to 1e-6, as under the defaults."""
    want = reference(name, kkt_solve_method=method)
    solver = _port(name, kkt_solve_method=method)
    got = solver.solve()
    _same_result(got, want, TOL_DEFAULT, TOL_OBJ)
    assert got.iterations == want.iterations
    assert solver.get_info()["linear_solver"]["method"] == method
    if got.status == ct.SolverStatus.SOLVED:
        assert got.r_prim < 1e-8 and got.r_dual < 1e-8


@pytest.mark.parametrize("method", ["qr", "inverse"])
def test_qr_and_inverse_f32_factor(reference, method):
    """An f32 QR or inverse refined in f64 takes the reference's
    iterations on the N = 76 portfolio."""
    got = _port("portfolio32", kkt_solve_method=method, **F32).solve()
    want = reference("portfolio32", kkt_solve_method=method, **F32)
    _same_result(got, want, TOL_DEFAULT, TOL_DEFAULT)
    assert got.iterations == want.iterations


def test_qr_matches_lu_on_qp():
    """tests/test_qr_backend.py:46 on the port."""
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.vstack([np.ones((1, 2)), np.eye(2), -np.eye(2)])
    b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    cones = [ct.ZeroConeT(1), ct.NonnegativeConeT(2), ct.NonnegativeConeT(2)]
    s1 = ct.Solver(P, q, A, b, cones, kkt_solve_method="qr",
                   device="cpu").solve()
    s2 = ct.Solver(P, q, A, b, cones, kkt_solve_method="lu",
                   device="cpu").solve()
    assert s1.status == ct.SolverStatus.SOLVED
    assert np.allclose(s1.x, s2.x, atol=1e-8)


@pytest.mark.parametrize("method", ["qr", "inverse"])
def test_qr_and_inverse_random_sweep(method):
    """tests/test_qr_backend.py:58 on the port: a random LP/QP/SOCP mix,
    held by first-principles residuals."""
    rng = np.random.default_rng(7)
    for t in range(12):
        n = int(rng.integers(4, 16))
        F = rng.standard_normal((n, max(2, n // 2)))
        P = F @ F.T + 0.1 * np.eye(n) if t % 3 else None
        q = rng.standard_normal(n)
        rows = [np.ones((1, n)), -np.eye(n)]
        b = np.concatenate([[1.0], np.zeros(n)])
        cones = [ct.ZeroConeT(1), ct.NonnegativeConeT(n)]
        if t % 2:
            G = rng.standard_normal((3, n)) / 3.0
            rows.append(np.vstack([np.zeros((1, n)), -G]))
            b = np.concatenate([b, [1.5], np.zeros(3)])
            cones.append(ct.SecondOrderConeT(4))
        A = np.vstack(rows)
        sol = ct.Solver(P, q, A, b, cones, kkt_solve_method=method,
                        device="cpu").solve()
        assert sol.status == ct.SolverStatus.SOLVED, (t, sol.status)
        assert np.abs(A @ sol.x + sol.s - b).max() < 1e-6, t
        Pd = P if P is not None else np.zeros((n, n))
        assert np.abs(Pd @ sol.x + q + A.T @ sol.z).max() < 1e-6, t


PHASES = ("scale_cones", "hs_assembly", "kkt_factor", "kkt_solve",
          "residuals", "step_length")


@pytest.mark.parametrize("name,pair", [("qp", True), ("portfolio64", False)])
def test_profile_phases(capsys, name, pair):
    """tests/test_misc_opt.py:163 on the port: a positive time for every
    phase, kkt_solve_pair where the backend pairs solves ("pallas"; the
    N = 148 portfolio takes "lu"), kept in timers["device"] and printed
    by print_timers."""
    solver = _port(name)
    solver.solve()
    ph = solver.profile_phases(reps=1)
    assert set(ph) == set(PHASES) | ({"kkt_solve_pair"} if pair else set())
    assert all(t > 0.0 for t in ph.values())
    assert solver.timers["device"] == ph
    solver.print_timers()
    assert "kkt_factor" in capsys.readouterr().out


def test_profile_dir_writes_a_trace(tmp_path):
    sol = _port("qp").solve(profile_dir=str(tmp_path))
    assert sol.status == ct.SolverStatus.SOLVED
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    import json

    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_solver_name_and_version(capsys):
    assert ct.solver_name() == "cuclarabel_torch"
    assert ct.version() == ct.__version__ == cc.version()
    _port("qp", verbose=True).solve()
    assert ct.solver_name() in capsys.readouterr().out
