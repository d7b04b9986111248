"""The port's block-arrow KKT and ShardedSolver (device="cpu", every
shard on the CPU) against the JAX package's, which shards over the 8
virtual CPU devices of tests/conftest.py.

Bars: pivotfree_inv within 1e-12 of the reference's, relative to the
largest entry; make_arrow_kkt within 1e-9 (NN rows) and 1e-7 (every
cone family, as tests/test_arrow_kkt.py holds the reference) of a dense
numpy solve of the unregularised system under the reference's
refinement, and on nonsymmetric layouts, where the port's refinement
holds the solve to the regularised saddle (kkt/arrow.py), within 1e-9
of a dense solve of that saddle; ShardedSolver against the
reference's ShardedSolver at the same n_devices (the row padding moves
the iterates away from the unsharded Solver's,
tests/test_sharded_single.py:43-45): the same status and iterations,
objective within 1e-8 relative, x within 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import cuclarabel_tpu as cc
from cuclarabel_tpu.kkt.dense import pivotfree_inv as ref_pivotfree_inv
from cuclarabel_tpu.parallel import ShardedSolver as RefShardedSolver
import cuclarabel_torch as ct
from cuclarabel_torch.cones import api
from cuclarabel_torch.cones import ops as cone_ops
from cuclarabel_torch.cones.layout import build_layout
from cuclarabel_torch.kkt.arrow import ShardedRows, make_arrow_kkt
from cuclarabel_torch.kkt.dense import pivotfree_inv
from cuclarabel_torch.parallel import ShardedSolver
from cuclarabel_torch.settings import Settings
from test_sharded_single import make_problem

CPU = torch.device("cpu")
NDEV = 8
TOL_OBJ = 1e-8
TOL_X = 1e-6


def _quasidefinite(N, rng):
    """A random regularised quasidefinite matrix: SPD leading block,
    negative definite trailing block."""
    k = (N + 1) // 2
    G = rng.standard_normal((k, k))
    H = rng.standard_normal((N - k, N - k))
    M = np.zeros((N, N))
    M[:k, :k] = G @ G.T + 0.1 * np.eye(k)
    M[k:, k:] = -(H @ H.T + 0.1 * np.eye(N - k))
    C = rng.standard_normal((N - k, k))
    M[k:, :k] = C
    M[:k, k:] = C.T
    return M


@pytest.mark.parametrize("N", [5, 9, 40])
def test_pivotfree_inv_matches_reference(N):
    M = _quasidefinite(N, np.random.default_rng(N))
    got = pivotfree_inv(torch.tensor(M)).numpy()
    want = np.asarray(ref_pivotfree_inv(jnp.asarray(M)))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(got @ M, np.eye(N), atol=1e-10)


def _run_arrow(n, m, layout, Pm, A, hs_parts, rx, rz, ndev=NDEV,
               refine_regularised=None):
    """(x and z concatenated, fac) of one refined arrow solve on ndev CPU
    shards."""
    factorize, solve = make_arrow_kkt(n, m, Settings(), layout, [CPU] * ndev,
                                      refine_regularised)
    assert factorize.structured_hs
    rows = ShardedRows.from_host(A, [CPU] * ndev)
    assert len(rows.slabs) == ndev
    assert {tuple(a.shape) for a in rows.slabs} == {(m // ndev, n)}
    fac, ok = factorize(torch.tensor(Pm)[None], rows, hs_parts)
    x, z, oks, nir = solve(fac, torch.tensor(rx)[None],
                           torch.tensor(rz)[None])
    assert bool(ok.all()) and bool(oks.all())
    return np.concatenate([x[0].numpy(), z[0].numpy()]), fac


def _refined_operator(fac, layout, A):
    """The augmented operator that refinement holds the solve to, in
    numpy from the factorization's record: [P A' 0; A -H V; 0 V' E] with
    H diagonal on the eliminated rows and Hex on the explicit ones."""
    plan = cone_ops.sparse_hs_plan(layout)
    ex = np.asarray(layout.zero_mask, dtype=bool).copy()
    ex[plan["blk_rows"]] = True
    ex[plan["blk_cols"]] = True
    m, n = A.shape
    H = np.diag(np.where(ex, 0.0, fac["hs_diag"].numpy()))
    idx = np.nonzero(ex)[0]
    H[np.ix_(idx, idx)] = fac["Hex"].numpy()
    V = (fac["V"].gather(fac["V"].slabs).numpy() if fac["V"] is not None
         else np.zeros((m, 0)))
    nw = V.shape[1]
    return np.block([
        [fac["P"].numpy(), A.T, np.zeros((n, nw))],
        [A, -H, V],
        [np.zeros((nw, n)), V.T, np.diag(fac["E"].numpy())],
    ])


def test_arrow_factor_shards_and_solves():
    """tests/test_arrow_kkt.py:30-72: NN rows only, 8 shards."""
    rng = np.random.default_rng(0)
    n, m = 12, 32
    A = rng.standard_normal((m, n))
    G = rng.standard_normal((n, n)) / np.sqrt(n)
    Pm = G @ G.T
    hd = rng.uniform(0.5, 2.0, m)
    layout = build_layout((api.NonnegativeConeT(m),))
    rx = rng.standard_normal(n)
    rz = rng.standard_normal(m)
    got, _ = _run_arrow(n, m, layout, Pm, A, (
        torch.tensor(hd)[None], torch.zeros(1, 0, dtype=torch.float64),
        [], []), rx, rz)
    ref = np.linalg.solve(np.block([[Pm, A.T], [A, -np.diag(hd)]]),
                          np.concatenate([rx, rz]))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("ndev", [1, NDEV])
@pytest.mark.parametrize("regularised", [False, None])
def test_arrow_structured_mixed_cones(ndev, regularised):
    """tests/test_arrow_kkt.py:73-132: expanded and small SOCs, exp,
    GenPow, PSD, zero and NN rows, cone blocks straddling the shards.
    Under the reference's refinement (regularised=False) against a dense
    solve of the KKT built from assemble_Hs_dense, at the reference
    test's 1e-7; under the port's default on this nonsymmetric layout
    (refinement held to the regularised saddle) against a dense solve of
    that saddle's augmented form within 1e-9, and within 1e-4 of the
    unregularised solve (the static regularisation's own effect)."""
    rng = np.random.default_rng(1)
    cones = (
        api.ZeroConeT(3),
        api.NonnegativeConeT(8),
        api.SecondOrderConeT(8),     # > 4: rank-2 expanded
        api.SecondOrderConeT(3),     # small: explicit dense block
        api.ExponentialConeT(),
        api.GenPowerConeT([0.3, 0.7], 2),
        api.PSDTriangleConeT(2),     # svec dim 3: explicit dense block
        api.NonnegativeConeT(8),
    )
    layout = build_layout(cones)
    m = layout.m
    assert m % NDEV == 0, m
    n = 10
    A = rng.standard_normal((m, n))
    G = rng.standard_normal((n, n)) / np.sqrt(n)
    Pm = G @ G.T + 0.1 * np.eye(n)

    z0, s0 = cone_ops.unit_initialization(layout, 1, CPU)
    s = s0 * torch.tensor(rng.uniform(0.9, 1.1, m))[None]
    z = z0 * torch.tensor(rng.uniform(0.9, 1.1, m))[None]
    mu = (s * z).sum(dim=1) / (layout.degree + 1)
    state, ok_s = cone_ops.update_scaling(layout, s, z, mu, 1)
    assert bool(ok_s.all())
    hs_parts = cone_ops.sparse_hs_values(
        layout, state, cone_ops.sparse_hs_plan(layout), 1, CPU)
    Hs = cone_ops.assemble_Hs_dense(layout, state)[0].numpy()

    rx = rng.standard_normal(n)
    rz = rng.standard_normal(m)
    got, fac = _run_arrow(n, m, layout, Pm, A, hs_parts, rx, rz, ndev,
                          regularised)
    ref = np.linalg.solve(np.block([[Pm, A.T], [A, -Hs]]),
                          np.concatenate([rx, rz]))
    if regularised is False:
        np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-7)
        return
    K = _refined_operator(fac, layout, A)
    aug = np.linalg.solve(K, np.concatenate([rx, rz, np.zeros(
        K.shape[0] - n - m)]))[:n + m]
    np.testing.assert_allclose(got, aug, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _exp_pow_problem(mod):
    """tests/test_sharded_single.py::test_sharded_exp_pow_matches_single."""
    rng = np.random.default_rng(11)
    n = 12
    q = rng.standard_normal(n) * 0.3
    A_exp = np.zeros((3, n))
    A_exp[:, 0:3] = -np.eye(3)
    A_pow = np.zeros((3, n))
    A_pow[:, 3:6] = -np.eye(3)
    A_nn = np.zeros((n - 6, n))
    A_nn[:, 6:] = -np.eye(n - 6)
    A = np.vstack([np.ones((1, n)), np.eye(n), A_exp, A_pow, A_nn])
    b = np.concatenate([[1.0], np.full(n, 2.0), np.zeros(3), np.zeros(3),
                        np.zeros(n - 6)])
    cones = [mod.ZeroConeT(1), mod.NonnegativeConeT(n),
             mod.ExponentialConeT(), mod.PowerConeT(0.4),
             mod.NonnegativeConeT(n - 6)]
    return None, q, A, b, cones


def _psd_problem(mod):
    """tests/test_sharded_single.py::test_sharded_psd_matches_single."""
    rng = np.random.default_rng(5)
    d = 4
    nsv = d * (d + 1) // 2

    def svec(M):
        return np.array([M[i, j] * (1.0 if i == j else np.sqrt(2.0))
                         for j in range(d) for i in range(j + 1)])

    Cm = rng.standard_normal((d, d))
    Cm = (Cm + Cm.T) / 2
    A = np.vstack([svec(np.eye(d))[None, :], -np.eye(nsv)])
    b = np.concatenate([[1.0], np.zeros(nsv)])
    return None, svec(Cm), A, b, [mod.ZeroConeT(1), mod.PSDTriangleConeT(d)]


def _socp_problem(mod):
    """tests/test_sharded_single.py::make_problem."""
    P, q, A, b, cones = make_problem()
    return P, q, A, b, [getattr(mod, type(c).__name__)(c.dim) for c in cones]


PROBLEMS = {"socp": _socp_problem, "exp_pow": _exp_pow_problem,
            "psd": _psd_problem}


@pytest.mark.parametrize("ndev", [1, 2, NDEV])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_sharded_solver_matches_reference(name, ndev):
    want = RefShardedSolver(*PROBLEMS[name](cc), n_devices=ndev).solve()
    solver = ShardedSolver(*PROBLEMS[name](ct), n_devices=ndev,
                           device="cpu")
    assert solver.tp_mode == "arrow"
    got = solver.solve()
    assert got.status.name == want.status.name == "SOLVED"
    assert got.iterations == want.iterations
    assert abs(got.obj_val - want.obj_val) <= TOL_OBJ * max(
        1.0, abs(want.obj_val))
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=TOL_X)


def test_padding_strips_back_to_m():
    """tests/test_sharded_single.py::test_sharded_pads_nondivisible_m:
    m = 46 on 8 shards, two inert padding rows; s and z returned at the
    caller's length, the objective within 1e-6 of the unsharded
    Solver's."""
    P, q, A, b, cones = make_problem(n=30, seed=2)
    cones = [getattr(ct, type(c).__name__)(c.dim) for c in cones]
    m = b.shape[0]
    assert m % NDEV != 0
    solver = ShardedSolver(P, q, A, b, cones, n_devices=NDEV, device="cpu")
    assert solver.m == m + (-m) % NDEV
    got = solver.solve()
    assert got.status == ct.SolverStatus.SOLVED
    assert got.s.shape == (m,) and got.z.shape == (m,)
    full = ct.Solver(P, q, A, b, cones, presolve_enable=False,
                     device="cpu").solve()
    assert abs(got.obj_val - full.obj_val) < 1e-6
    # s = b - A x on every original row
    np.testing.assert_allclose(got.s, b - A @ got.x, atol=1e-6)


def test_update_data_and_warm_start():
    """tests/test_sharded_single.py::test_sharded_update_data_resolves on
    4 shards, then a warm start from the updated solution."""
    P, q, A, b, cones = _socp_problem(ct)
    sh = ShardedSolver(P, q, A, b, cones, n_devices=4, device="cpu")
    sh.solve()
    rng = np.random.default_rng(7)
    q2 = q + 0.1 * rng.standard_normal(q.shape[0])
    b2 = b.copy()
    b2[-8] = 4.0
    sh.update_data(q=q2, b=b2)
    sol = sh.solve()
    fresh = ShardedSolver(P, q2, A, b2, cones, n_devices=4,
                          device="cpu").solve()
    assert sol.status == ct.SolverStatus.SOLVED
    assert sol.iterations == fresh.iterations
    assert abs(sol.obj_val - fresh.obj_val) < 1e-9 * max(
        1.0, abs(fresh.obj_val))

    P2 = P * 1.5
    A2 = A.copy()
    A2[:8] *= 1.1
    b3 = b2.copy()
    b3[:8] *= 1.1
    sh.update_data(P=P2, A=A2, b=b3)
    sol2 = sh.solve()
    ref2 = ct.Solver(P2, q2, A2, b3, cones, presolve_enable=False,
                     device="cpu").solve()
    assert sol2.status == ct.SolverStatus.SOLVED
    assert abs(sol2.obj_val - ref2.obj_val) < 1e-6

    sh.update_data(q=1.01 * q2)
    warm = sh.solve(warm_start=(sol2.x, sol2.s, sol2.z))
    cold = ShardedSolver(P2, 1.01 * q2, A2, b3, cones, n_devices=4,
                         device="cpu").solve()
    assert warm.status == ct.SolverStatus.SOLVED
    assert abs(warm.obj_val - cold.obj_val) < 1e-6
    assert warm.iterations < cold.iterations
    with pytest.raises(ValueError):
        sh.update_data(P=np.zeros_like(P))


def test_repeat_solve_is_bitwise_equal():
    solver = ShardedSolver(*_socp_problem(ct), n_devices=NDEV, device="cpu")
    a = solver.solve()
    b = solver.solve()
    assert a.iterations == b.iterations
    for f in ("x", "s", "z"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_arrow_needs_shards_and_cards():
    P, q, A, b, cones = _socp_problem(ct)
    with pytest.raises(ValueError, match="shard devices"):
        ct.Solver(P, q, A, b, cones, direct_solve_method="arrow",
                  device="cpu").solve()
    with pytest.raises(ValueError, match="block-arrow"):
        ShardedSolver(P, q, A, b, cones, direct_solve_method="qdldl",
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ShardedSolver(P, q, A, b, cones, n_devices=2)
    else:
        have = torch.cuda.device_count()
        with pytest.raises(ValueError, match=str(have)):
            ShardedSolver(P, q, A, b, cones, n_devices=have + 1)


def _script_make_qp():
    """scripts/arrow_scaling.py::make_qp, taken out with ast (the script
    runs its scaling table at import)."""
    import ast
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "scripts"
           / "arrow_scaling.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "make_qp")
    ns = {"np": np, "cc": cc}
    exec(compile(ast.Module([fn], []), "make_qp", "exec"), ns)
    return ns["make_qp"]


def test_box_budget_qp_matches_script_and_reference():
    """problems.box_budget_qp is the script's make_qp to the bit, and the
    port's ShardedSolver solves it as the reference's does (2 shards)."""
    from cuclarabel_torch.problems import box_budget_qp

    make_qp = _script_make_qp()
    for n, m_in in ((8, 40), (32, 1024)):
        got, want = box_budget_qp(n, m_in, 3), make_qp(n, m_in, 3)
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a, b)
        assert [(type(c).__name__, c.dim) for c in got[4]] == [
            (type(c).__name__, c.dim) for c in want[4]]
    want = RefShardedSolver(*make_qp(32, 1024, 0), n_devices=2).solve()
    got = ShardedSolver(*box_budget_qp(32, 1024, 0), n_devices=2,
                        device="cpu").solve()
    assert got.status.name == want.status.name == "SOLVED"
    assert got.iterations == want.iterations
    assert abs(got.obj_val - want.obj_val) <= TOL_OBJ * abs(want.obj_val)


def test_saddle_inverse_guard():
    """saddle_inverse keeps the pivot-free inverse where its residual is
    small (bitwise the reference's recursion) and takes pivoted LU's
    where the recursion has lost the inverse: an SPD block with
    eigenvalues from 1 to 1e12 bordered by one zero-cone row, the shape
    of the box QP's saddle near its solution."""
    from cuclarabel_torch.kkt import arrow

    rng = np.random.default_rng(4)
    M = torch.tensor(_quasidefinite(20, rng))
    arrow.SADDLE_INVERSES.clear()
    np.testing.assert_array_equal(arrow.saddle_inverse(M).numpy(),
                                  pivotfree_inv(M).numpy())
    assert dict(arrow.SADDLE_INVERSES) == {"pivotfree": 1}

    n = 40
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    S = (Q * np.logspace(0, 12, n)) @ Q.T
    a = rng.standard_normal((n, 1))
    M = torch.tensor(np.block([[S, a], [a.T, -1e-8 * np.ones((1, 1))]]))
    eye = torch.eye(n + 1, dtype=torch.float64)
    bad = float((M @ pivotfree_inv(M) - eye).abs().max())
    assert bad > arrow.INVERSE_RESIDUAL_MAX
    X = arrow.saddle_inverse(M)
    assert dict(arrow.SADDLE_INVERSES) == {"pivotfree": 1, "lu": 1}
    assert float((M @ X - eye).abs().max()) < bad
