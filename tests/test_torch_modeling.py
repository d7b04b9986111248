"""The port's modeling layer (cuclarabel_torch.modeling, a copy of the
JAX-free reference) against the reference's, on the CPU.

Every case of tests/test_modeling.py is built through both packages'
Model: the assembled (P, q, A, b, cones) are equal bit for bit, the
statuses equal, and the objectives within 1e-7 relative (floor 1), the
sparse backend included.  Every template of
tests/test_modeling_conformance.py runs through the port's Model at 4
draws (2 on the sparse backend) held to that battery's first-principles
optimality conditions at its TOL (5e-6), and the two infeasibility
certificates at 4 draws each."""

import zlib

import numpy as np
import pytest

from cuclarabel_tpu import modeling as ref_md
from cuclarabel_tpu.cones import api as ref_api
from cuclarabel_tpu.statuscodes import SolverStatus as RefStatus
import cuclarabel_torch as ct
from cuclarabel_torch import modeling as md
from cuclarabel_torch.cones import api
import tests.test_modeling_conformance as conf

TOL_OBJ = 1e-7
DRAWS = 4
SPARSE_DRAWS = 2


# ------------------------------------------------ tests/test_modeling.py

def basic_qp(md, api, m):
    x = m.add_variables(2)
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    m.minimize(0.5 * md.quad_form(x, P) + np.array([1.0, 1.0]) @ x)
    m.add_constraint(md.sum_entries(x) == 1.0)
    m.add_constraint(x >= 0.0)
    m.add_constraint(x <= np.array([0.7, 0.7]))
    return {"x": (x, [0.3, 0.7]), "obj": 1.8800000298}


def maximize_sense_flip(md, api, m):
    x = m.add_variables(2)
    m.maximize(-md.sumsq(x) + np.array([2.0, 4.0]) @ x)
    m.add_constraint(x <= np.array([10.0, 10.0]))
    return {"x": (x, [1.0, 2.0]), "obj": 5.0}


def socp(md, api, m):
    x = m.add_variables(2)
    m.minimize(x @ np.array([0.0, 1.0]))
    m.add_constraint(md.norm2(md.vstack([x[0:1], x[1:2] - 1.0])) <= 1.0)
    return {"x": (x, [0.0, 0.0]), "obj": 0.0}


def exp_cone(md, api, m):
    x = m.add_variables(3)
    m.add_constraint(x, api.ExponentialConeT())
    m.add_constraint(x[1:2] == 1.0)
    m.add_constraint(x[2:3] == float(np.e))
    m.maximize(x @ np.array([1.0, 0.0, 0.0]))
    return {"obj": 1.0}


def pow_cone(md, api, m):
    v = m.add_variables(3)
    m.add_constraint(v, api.PowerConeT(0.6))
    m.add_constraint(v[0:1] == 2.0)
    m.add_constraint(v[1:2] == 1.0)
    m.maximize(v @ np.array([0.0, 0.0, 1.0]))
    return {"obj": 2.0 ** 0.6}


def genpow_cone(md, api, m):
    v = m.add_variables(3)
    m.add_constraint(v, api.GenPowerConeT((0.4, 0.6), 1))
    m.add_constraint(v[0:1] == 2.0)
    m.add_constraint(v[1:2] == 3.0)
    m.maximize(v @ np.array([0.0, 0.0, 1.0]))
    return {"obj": 2.0 ** 0.4 * 3.0 ** 0.6}


def psd_cone(md, api, m):
    xs = m.add_variables(3)
    eye_svec = np.array([1.0, 0.0, 1.0])
    m.add_constraint(xs - eye_svec, api.PSDTriangleConeT(2))
    m.minimize(xs @ np.array([1.0, 0.0, 1.0]))
    return {"x": (xs, eye_svec), "obj": 2.0}


def duals_and_slacks(md, api, m):
    x = m.add_variables(2)
    c1 = m.add_constraint(md.sum_entries(x) == 1.0)
    c2 = m.add_constraint(x >= 0.0)
    m.minimize(0.5 * md.sumsq(x))
    return {"x": (x, [0.5, 0.5]), "dual": (c1, [0.5]),
            "slack": (c2, [0.5, 0.5])}


def lasso(md, api, m):
    rng = np.random.default_rng(12345)
    n, mrows = 8, 400
    F = rng.random((mrows, n))
    vtrue = np.zeros(n)
    vtrue[rng.random(n) < 0.2] = rng.random()
    bvec = F @ vtrue + 0.1 * rng.random(mrows)
    mu = 0.1 * np.abs(F.T @ bvec).max()
    v = m.add_variables(n)
    u = m.add_variables(n)
    m.add_constraint(v <= u)
    m.add_constraint(-1.0 * u <= v)
    m.minimize(md.sumsq(F @ v - bvec) + mu * md.sum_entries(u))
    return {}


def psd_sugar(md, api, m):
    t = m.add_variables(1)
    m.add_psd_constraint([[t, 1.0], [1.0, t]])
    m.minimize(t @ np.array([1.0]))
    return {"x": (t, [1.0])}


def psd_matrix_completion(md, api, m):
    x = m.add_variables(1)
    m.add_psd_constraint([[1.0, x, 0.0], [x, 1.0, x], [0.0, x, 1.0]])
    m.minimize(x @ np.array([1.0]))
    return {"x": (x, [-1.0 / np.sqrt(2.0)])}


def lp(md, api, m):
    y = m.add_variables(3)
    m.minimize(np.array([1.0, 2.0, 3.0]) @ y)
    m.add_constraint(md.sum_entries(y) == 1.0)
    m.add_constraint(y >= 0.0)
    return {"obj": 1.0}


def infeasible(md, api, m):
    x = m.add_variables(1)
    m.add_constraint(x >= 1.0)
    m.add_constraint(x <= 0.0)
    m.minimize(x @ np.array([1.0]))
    return {}


# (name, builder, solve kwargs): every solved case of test_modeling.py,
# the epigraph bridge (use_quad_obj=False) and the sparse backend on
# the QP and the LP among them
CASES = [
    ("basic_qp", basic_qp, {}),
    ("qp_epigraph_bridge", basic_qp, {"use_quad_obj": False}),
    ("maximize_sense_flip", maximize_sense_flip, {}),
    ("socp", socp, {}),
    ("exp_cone", exp_cone, {}),
    ("pow_cone", pow_cone, {}),
    ("genpow_cone", genpow_cone, {}),
    ("psd_cone", psd_cone, {}),
    ("infeasible_status_mapping", infeasible, {}),
    ("duals_and_slacks", duals_and_slacks, {}),
    ("lasso_via_builder", lasso, {}),
    ("psd_constraint_sugar", psd_sugar, {}),
    ("psd_constraint_matrix_completion", psd_matrix_completion, {}),
    ("sparse_backend_qp", basic_qp, {"backend": "sparse"}),
    ("sparse_backend_lp", lp, {"backend": "sparse"}),
]


def _same_assembly(got, want):
    for a, b in zip(got[:4], want[:4]):
        if a is None or b is None:
            assert a is None and b is None
            continue
        if hasattr(a, "toarray"):
            a, b = a.toarray(), b.toarray()
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [type(c).__name__ for c in got[4]] == [
        type(c).__name__ for c in want[4]]
    for a, b in zip(got[4], want[4]):
        assert vars(a) == vars(b)
    assert got[5] == want[5]


@pytest.mark.parametrize("name,build,kw", CASES, ids=[c[0] for c in CASES])
def test_model_matches_reference(name, build, kw):
    mine, ref = md.Model(device="cpu"), ref_md.Model()
    checks = build(md, api, mine)
    build(ref_md, ref_api, ref)
    uqo = kw.get("use_quad_obj", True)
    sparse = kw.get("backend") == "sparse"
    if uqo:  # the bridge adds its epigraph rows while it assembles
        _same_assembly(mine._assemble(uqo, sparse=sparse),
                       ref._assemble(uqo, sparse=sparse))
    got, want = mine.solve(**kw), ref.solve(**kw)
    if not uqo:
        _same_assembly(mine._assemble(True), ref._assemble(True))
    if sparse:
        assert isinstance(mine.solver, ct.SparseSolver)
    else:
        assert isinstance(mine.solver, ct.Solver)
    assert mine.solver.device.type == "cpu"
    assert got.status.name == want.status.name
    assert mine.termination_status == ref.termination_status
    assert mine.primal_status == ref.primal_status
    assert mine.dual_status == ref.dual_status
    if want.status == RefStatus.SOLVED:
        err = abs(mine.objective_value - ref.objective_value)
        assert err <= TOL_OBJ * max(1.0, abs(ref.objective_value))
        if "obj" in checks:
            assert np.isclose(mine.objective_value, checks["obj"], atol=1e-4)
        if "x" in checks:
            var, val = checks["x"]
            np.testing.assert_allclose(var.value, val, atol=1e-3)
        if "dual" in checks:
            c, val = checks["dual"]
            np.testing.assert_allclose(np.abs(c.dual), val, atol=1e-6)
        if "slack" in checks:
            c, val = checks["slack"]
            np.testing.assert_allclose(c.slack, val, atol=1e-6)
    else:
        assert got.status in (ct.SolverStatus.PRIMAL_INFEASIBLE,
                              ct.SolverStatus.ALMOST_PRIMAL_INFEASIBLE)


def test_expression_algebra_and_mixed_models():
    """tests/test_modeling.py::test_expression_algebra and
    ::test_mixed_model_rejected through the port's Model."""
    m = md.Model(device="cpu")
    x = m.add_variables(3)
    e = 2.0 * x - np.array([1.0, 2.0, 3.0])
    M = np.arange(6.0).reshape(2, 3)
    f = M @ e + 1.0
    assert f.k == 2
    m._x = np.array([1.0, 1.0, 1.0])
    np.testing.assert_allclose(e.value, [1.0, 0.0, -1.0])
    np.testing.assert_allclose(f.value, M @ np.array([1.0, 0.0, -1.0]) + 1.0)
    assert np.isclose(md.quad_form(e, np.eye(3)).value, 2.0)
    assert np.isclose(md.sumsq(x).value, 3.0)
    m1, m2 = md.Model(), md.Model()
    x1, x2 = m1.add_variables(2), m2.add_variables(2)
    with pytest.raises(ValueError):
        x1 + x2
    with pytest.raises(ValueError, match="backend"):
        m.add_constraint(x >= 0.0)
        m.minimize(md.sum_entries(x))
        m.solve(backend="other")


# ------------------------------------ tests/test_modeling_conformance.py

def _rng(name, draw):
    return np.random.default_rng([zlib.crc32(name.encode()), draw])


@pytest.fixture
def port_templates(monkeypatch):
    """The conformance templates build through the module globals `md`
    and `cc`: point them at the port for the test."""
    monkeypatch.setattr(conf, "md", md)
    monkeypatch.setattr(conf, "cc", ct)


def _kkt_check(model, use_quad_obj=True):
    """tests/test_modeling_conformance.py::_kkt_check with the port's
    cone classes: stationarity, primal residual, duality gap and cone
    membership at TOL times the problem's scale, and the reported
    objective."""
    P, q, A, b, cones, const = model._assemble(use_quad_obj)
    x, z, s = model._x, model._z, model._s
    scale = max(1.0, np.abs(q).max(initial=0.0), np.abs(b).max(initial=0.0),
                np.abs(x).max(initial=0.0), np.abs(z).max(initial=0.0))
    tol = conf.TOL * scale
    assert np.abs(P @ x + q + A.T @ z).max() <= tol, "stationarity"
    assert np.abs(A @ x + s - b).max() <= tol, "primal residual"
    assert abs(x @ P @ x + q @ x + b @ z) <= tol, "duality gap"
    off = 0
    for c in cones:
        k = api.nvars(c)
        blk, zblk = s[off:off + k], z[off:off + k]
        if isinstance(c, api.ZeroConeT):
            assert np.abs(blk).max(initial=0.0) <= tol
        elif isinstance(c, api.NonnegativeConeT):
            assert blk.min(initial=0.0) >= -tol
            assert zblk.min(initial=0.0) >= -tol
        elif isinstance(c, api.SecondOrderConeT):
            assert blk[0] >= np.linalg.norm(blk[1:]) - tol
            assert zblk[0] >= np.linalg.norm(zblk[1:]) - tol
        off += k
    obj = 0.5 * x @ P @ x + q @ x + const
    assert model.objective_value == pytest.approx(model._sense * obj,
                                                  abs=1e-6, rel=1e-6)


@pytest.mark.parametrize("name,build,uqo", conf.FEASIBLE_TEMPLATES,
                         ids=[t[0] for t in conf.FEASIBLE_TEMPLATES])
def test_conformance_feasible(port_templates, name, build, uqo):
    for draw in range(DRAWS):
        m = md.Model(verbose=False, device="cpu")
        expected = build(_rng(name, draw), m)
        sol = m.solve(use_quad_obj=uqo)
        assert sol.status == ct.SolverStatus.SOLVED, (name, draw)
        if uqo:
            _kkt_check(m)
        else:
            m2 = md.Model(verbose=False, device="cpu")
            build(_rng(name, draw), m2)
            assert m2.solve().status == ct.SolverStatus.SOLVED
            assert m.objective_value == pytest.approx(
                m2.objective_value, abs=1e-5, rel=1e-6), (name, draw)
        if expected is not None:
            assert m.objective_value == pytest.approx(
                expected, abs=5e-6, rel=5e-6), (name, draw)


def test_conformance_sparse_backend(port_templates):
    for draw in range(SPARSE_DRAWS):
        m = md.Model(verbose=False, device="cpu")
        conf.t_eq_nn_qp(_rng("sparse", draw), m)
        assert m.solve(backend="sparse").status == ct.SolverStatus.SOLVED
        assert isinstance(m.solver, ct.SparseSolver)
        _kkt_check(m)


def test_conformance_primal_infeasible():
    """A'z ~ 0 with b'z < 0 (info.jl:301-317)."""
    for draw in range(DRAWS):
        rng = _rng("pinf", draw)
        m = md.Model(verbose=False, device="cpu")
        x = m.add_variables(3)
        gap = float(rng.uniform(0.1, 2.0))
        m.add_constraint(x >= 1.0)
        m.add_constraint(md.sum_entries(x) <= 3.0 - gap)
        m.minimize(md.sum_entries(x))
        sol = m.solve()
        assert sol.status == ct.SolverStatus.PRIMAL_INFEASIBLE, draw
        assert m.termination_status == "INFEASIBLE"
        assert np.isnan(sol.obj_val)
        P, q, A, b, cones, const = m._assemble(True)
        z = m._z
        assert b @ z < 0
        assert np.abs(A.T @ z).max() <= 1e-6 * max(1.0, np.abs(z).max())


def test_conformance_dual_infeasible():
    """P x ~ 0, A x + s ~ 0 with q'x < 0 (info.jl:318-331)."""
    for draw in range(DRAWS):
        rng = _rng("dinf", draw)
        m = md.Model(verbose=False, device="cpu")
        x = m.add_variables(2)
        c = 1.0 + float(rng.random())
        m.add_constraint(x >= 0.0)
        m.minimize(-c * x[0] - x[1])
        sol = m.solve()
        assert sol.status == ct.SolverStatus.DUAL_INFEASIBLE, draw
        assert m.termination_status == "DUAL_INFEASIBLE"
        P, q, A, b, cones, const = m._assemble(True)
        xr, sr = m._x, m._s
        nx = max(1.0, np.abs(xr).max())
        assert q @ xr < 0
        assert np.abs(P @ xr).max() <= 1e-6 * nx
        assert np.abs(A @ xr + sr).max() <= 1e-6 * nx
