"""The port's BatchSolver (device="cpu") on batches with exponential, power
and generalised power cones, against single-problem solves of the
reference (never a CPU-vmapped reference at B = 4: ROADMAP F2), with the
reference's own bars (tests/test_batch_sharding.py:142-281): the batch
and single pipelines equilibrate differently (device against host), so
they are held to solution quality, not to one iterate path.

Also: the per-problem strategy ladder on the divergence batch of
test_batch_strategy_divergence and on a second one, against the
reference's BatchSolver under "lu" and under "pallas", staged
compaction against the plain loop on an exp batch, the generalised-power
family against its analytic optima, and the warm portfolio re-solve of
ROADMAP F7."""

import numpy as np
import pytest

import cuclarabel_tpu as cc
from cuclarabel_tpu.parallel import BatchSolver as RefBatchSolver
from __graft_entry__ import _portfolio_socp
import cuclarabel_torch as ct
from cuclarabel_torch.problems import exp_logistic, genpow_family
from cuclarabel_torch.problems import portfolio_socp

B = 5


def _single(qs, A, bs, cones, i, P=None):
    Ai = A[i] if A.ndim == 3 else A
    return cc.Solver(P, qs[i], Ai, bs[i], cones,
                     presolve_enable=False).solve()


def _exp_data(mod, batch):
    """test_batch_exp_matches_single's batch, at `batch` problems."""
    c = np.array([-1.0, 0.0, 0.5])
    A = np.vstack([np.array([[0.0, 1.0, 0.0]]),
                   np.array([[0.0, 0.0, 1.0]]), -np.eye(3)])
    bs = np.stack([np.concatenate([[1.0], [1.5 + 0.8 * i], np.zeros(3)])
                   for i in range(batch)])
    cones = [mod.ZeroConeT(1), mod.NonnegativeConeT(1), mod.ExponentialConeT()]
    return np.tile(c, (batch, 1)), A, bs, cones


def test_batch_exp_matches_single():
    qs, A, bs, cones = _exp_data(ct, B)
    sols = ct.BatchSolver(None, qs, A, bs, cones, device="cpu").solve()
    _, _, _, rcones = _exp_data(cc, B)
    for i, s in enumerate(sols):
        ref = _single(qs, A, bs, rcones, i)
        assert ref.status == cc.SolverStatus.SOLVED
        assert s.status in (ct.SolverStatus.SOLVED,
                            ct.SolverStatus.ALMOST_SOLVED), (i, s.status)
        assert abs(s.obj_val - ref.obj_val) < 1e-6, (i, s.obj_val,
                                                     ref.obj_val)
        assert np.linalg.norm(s.x - ref.x) < 1e-3


def test_batch_pow_genpow_matches_single():
    c = np.array([0.1, 0.1, -1.0])
    A = np.vstack([np.array([[1.0, 1.0, 0.0]]), -np.eye(3)])
    bs = np.stack([np.concatenate([[1.6 + 0.4 * i], np.zeros(3)])
                   for i in range(B)])
    qs = np.tile(c, (B, 1))
    sols = ct.BatchSolver(None, qs, A, bs, [ct.NonnegativeConeT(1),
                                            ct.PowerConeT(0.6)],
                          device="cpu").solve()
    for i, s in enumerate(sols):
        ref = _single(qs, A, bs, [cc.NonnegativeConeT(1),
                                  cc.PowerConeT(0.6)], i)
        assert s.status == ct.SolverStatus.SOLVED
        assert abs(s.obj_val - ref.obj_val) < 1e-6

    a = [0.3, 0.7]
    c2 = np.array([0.0, 0.0, -1.0])
    bs2 = np.stack([np.concatenate([[1.8 + 0.25 * i], np.zeros(3)])
                    for i in range(B)])
    qs2 = np.tile(c2, (B, 1))
    solver = ct.BatchSolver(None, qs2, A, bs2, [ct.NonnegativeConeT(1),
                                                ct.GenPowerConeT(a, 1)],
                            device="cpu")
    sols2 = solver.solve()
    for i, s in enumerate(sols2):
        ref = _single(qs2, A, bs2, [cc.NonnegativeConeT(1),
                                    cc.GenPowerConeT(a, 1)], i)
        assert s.status == ct.SolverStatus.SOLVED
        assert abs(s.obj_val - ref.obj_val) < 1e-6
    assert solver.raw["scaling"].tolist() == [1] * B  # Dual only


# the divergence batches: (hard q, hard b) of the middle problem
DIVERGENCE = {
    # tests/test_batch_sharding.py::test_batch_strategy_divergence
    "reference": ([-213308.78098860086, 0.0, 0.003037962766862291],
                  [0.002042543869636034, 0.4080186873038148, 0.0, 0.0, 0.0]),
    # found by a scripted search: the middle problem downgrades in both
    # "lu" batch pipelines, the reference's and the port's
    "both": ([-109468.48966924052, 0.0, 0.010913989360765855],
             [0.011054918313718708, 1.530757394634138, 0.0, 0.0, 0.0]),
}
# terminal strategies of the port's BatchSolver under "lu" (under
# "pallas" they equal the reference's "pallas" ones, [0, 0, 0])
PORT_LU = {"reference": [0, 0, 0], "both": [0, 1, 0]}


def _strategies(solver):
    solver.solve()
    return np.asarray(solver.raw["scaling"]).tolist()


@pytest.mark.parametrize("batch", sorted(DIVERGENCE))
def test_batch_strategy_divergence(batch):
    """tests/test_batch_sharding.py::test_batch_strategy_divergence on the
    port: problems whose scaling strategies diverge, the middle one
    downgrading PrimalDual -> Dual through the ladder while its
    neighbours keep PrimalDual.

    The reference's BatchSolver ends [0, 1, 0] under "lu", its CPU
    method, as its test asserts; but that downgrade is a knife edge of
    its "lu" arithmetic: the middle problem alone (B = 1) keeps
    PrimalDual there, and under "pallas", the method the port's default
    ports, the reference's batch ends [0, 0, 0].  The port's "pallas"
    batch ends as the reference's "pallas" batch, and its "lu" batch
    ends [0, 1, 0] on the second batch, as the reference's does; there a
    ladder that reduced over the batch would downgrade all three or
    none.  Every problem solves within 1e-6 of its single reference
    solve."""
    A = np.vstack([np.array([[0.0, 1.0, 0.0]]),
                   np.array([[0.0, 0.0, 1.0]]), -np.eye(3)])
    easy_q = np.array([-1.0, 0.0, 0.5])
    easy_b = np.array([1.0, 2.0, 0.0, 0.0, 0.0])
    hard_q, hard_b = (np.array(v) for v in DIVERGENCE[batch])
    qs = np.stack([easy_q, hard_q, easy_q])
    bs = np.stack([easy_b, hard_b, easy_b])
    rcones = [cc.ZeroConeT(1), cc.NonnegativeConeT(1), cc.ExponentialConeT()]
    pcones = [ct.ZeroConeT(1), ct.NonnegativeConeT(1), ct.ExponentialConeT()]

    assert _strategies(RefBatchSolver(None, qs, A, bs, rcones,
                                      kkt_solve_method="lu")) == [0, 1, 0]
    assert _strategies(RefBatchSolver(None, qs[1:2], A, bs[1:2], rcones,
                                      kkt_solve_method="lu")) == [0]
    ref_pallas = _strategies(RefBatchSolver(None, qs, A, bs, rcones,
                                            kkt_solve_method="pallas"))
    assert ref_pallas == [0, 0, 0]
    for method, want in (("pallas", ref_pallas), ("lu", PORT_LU[batch])):
        solver = ct.BatchSolver(None, qs, A, bs, pcones, device="cpu",
                                kkt_solve_method=method)
        sols = solver.solve()
        assert solver.raw["scaling"].tolist() == want, method
        for i, s in enumerate(sols):
            ref = _single(qs, A, bs, rcones, i)
            assert s.status == ct.SolverStatus.SOLVED, (method, i, s.status)
            rel = abs(s.obj_val - ref.obj_val) / max(1.0, abs(ref.obj_val))
            assert rel < 1e-6, (method, i, s.obj_val, ref.obj_val)


def test_exp_logistic_batch_matches_single():
    """The slice's problem, N = 104, at B = 5 against single reference
    solves: SOLVED, objective within 1e-6 relative."""
    P, qs, A, bs, cones = exp_logistic(4, 10, B, 5)
    sols = ct.BatchSolver(P, qs, A, bs, cones, device="cpu").solve()
    rcones = [cc.NonnegativeConeT(10)] + [cc.ExponentialConeT()] * 20
    for i, s in enumerate(sols):
        ref = _single(qs, A, bs, rcones, i, P=P)
        assert s.status == ct.SolverStatus.SOLVED, (i, s.status)
        assert ref.status == cc.SolverStatus.SOLVED
        rel = abs(s.obj_val - ref.obj_val) / abs(ref.obj_val)
        assert rel < 1e-6, (i, s.obj_val, ref.obj_val)


def test_exp_logistic_batch_ends_solved():
    """ROADMAP F8: 100 exp_logistic problems (seed 1000) under "pallas"
    all end SOLVED, as in the reference's "pallas" batch (none of 300
    ALMOST_SOLVED there).  With the refinement held to the unregularised
    K instead (`python -m tests.torch_f8_rates port-pallas 100 1000
    --unregularised`), 4 of these 100 end ALMOST_SOLVED."""
    P, qs, A, bs, cones = exp_logistic(4, 10, 100, 1000)
    sols = ct.BatchSolver(P, qs, A, bs, cones, device="cpu").solve()
    assert [i for i, s in enumerate(sols)
            if s.status != ct.SolverStatus.SOLVED] == []


def test_genpow_family_optima():
    P, qs, A, bs, cones, optima = genpow_family(8, B, 9)
    sols = ct.BatchSolver(P, qs, A, bs, cones, device="cpu").solve()
    for s, opt in zip(sols, optima):
        assert s.status == ct.SolverStatus.SOLVED
        assert abs(s.obj_val - opt) <= 1e-6 * abs(opt), (s.obj_val, opt)


@pytest.mark.parametrize("method", ["pallas", "lu"])
def test_staged_compaction_matches_plain(method):
    """Staged compaction (quorum 0.5, B = 16) against the plain loop on
    an exp batch: the ladder's state (scaling, prev_vars) moves with the
    stragglers, so every problem ends as on the plain path."""
    qs, A, bs, cones = _exp_data(ct, 16)
    bs[:, 1] = 1.5 + 0.3 * np.arange(16) ** 1.5  # a spread of iterations
    plain = ct.BatchSolver(None, qs, A, bs, cones, device="cpu",
                           kkt_solve_method=method, batch_compaction=0.0)
    staged = ct.BatchSolver(None, qs, A, bs, cones, device="cpu",
                            kkt_solve_method=method, batch_compaction=0.5)
    want, got = plain.solve(), staged.solve()
    assert staged.last_compaction["remainder"] > 0
    for g, w in zip(got, want):
        assert g.status == w.status
        assert g.iterations == w.iterations
        assert abs(g.obj_val - w.obj_val) <= 1e-9 * max(1.0, abs(w.obj_val))
        if method == "pallas":  # per-problem arithmetic throughout
            np.testing.assert_array_equal(g.x, w.x)
    assert staged.raw["scaling"].tolist() == plain.raw["scaling"].tolist()


def test_warm_resolve_zero_pivot():
    """ROADMAP F7: the portfolio SOCP at nass = 8, seed 7, B = 16, re-solved
    warm after update_data(q=1.01 q).  Under "pallas" the factor of
    problem 7's third pass met a pivot that cancels to exactly zero
    (D^-1 = inf, the solve NaN, the problem ALMOST_SOLVED); the reference's
    "pallas" (interpret mode) and "lu" end SOLVED.  A zero pivot now takes
    its row's static regularization, and the problem solves as in the
    reference."""
    A, qs, bs, cones = portfolio_socp(nass=8, batch=16, seed=7)
    solver = ct.BatchSolver(None, qs, A, bs, cones, device="cpu",
                            kkt_solve_method="pallas")
    cold = solver.solve()
    solver.update_data(q=1.01 * qs)
    start = tuple(np.stack([getattr(s, f) for s in cold])
                  for f in ("x", "s", "z"))
    warm = solver.solve(warm_start=start)
    assert [s.status for s in warm] == [ct.SolverStatus.SOLVED] * 16

    rA, rqs, rbs, rcones = _portfolio_socp(nass=8, batch=16, seed=7)
    ref = RefBatchSolver(None, rqs, rA, rbs, rcones)  # "lu" on the CPU
    rcold = ref.solve()
    ref.update_data(q=1.01 * rqs)
    rwarm = ref.solve(warm_start=tuple(
        np.stack([getattr(s, f) for s in rcold]) for f in ("x", "s", "z")))
    for g, w in zip(warm, rwarm):
        assert w.status == cc.SolverStatus.SOLVED
        assert g.iterations == w.iterations
        assert abs(g.obj_val - w.obj_val) <= 1e-7 * abs(w.obj_val)


def test_zero_pivot_takes_the_regularization():
    """The plain factor on a 2 x 2 K whose second pivot cancels to exactly
    zero: D = (1, reg[1]), finite, where the parent's gave D^-1 = inf."""
    import torch
    from cuclarabel_torch.kkt import ldl

    r = 2.0 ** -30
    K = torch.tensor([[[1.0, 0.0], [1.0, 1.0 - r]]], dtype=torch.float64)
    reg = torch.tensor([[0.0, r]], dtype=torch.float64)
    L, Dinv, ok = ldl.ldl_factor(K, reg)
    assert bool(ok.all())
    assert Dinv.tolist() == [[1.0, 1.0 / r]]
    assert L.tolist() == [[[0.0, 0.0], [1.0, 0.0]]]
    K0 = torch.tensor([[[1.0, 0.0], [1.0, 1.0]]], dtype=torch.float64)
    _, _, ok0 = ldl.ldl_factor(K0, torch.zeros_like(reg))
    assert not bool(ok0.all())  # a zero regularization leaves it zero


def test_numerical_error_retries_under_dual(monkeypatch):
    """The numerical-error rung of the ladder (reference loop.py:765-775),
    per problem: a factor that fails for problem 1 in the fourth pass sends
    that problem alone to Dual scaling, uncommitted, and it still solves;
    problems 0 and 2 end exactly as without the failure."""
    import torch
    from cuclarabel_torch.kkt import dense

    qs, A, bs, cones = _exp_data(ct, 3)
    want = ct.BatchSolver(None, qs, A, bs, cones, device="cpu")
    ref = want.solve()
    assert want.raw["scaling"].tolist() == [0, 0, 0]
    calls = []
    factor = dense.ldl_factor

    def failing(K, reg):
        L, Dinv, ok = factor(K, reg)
        calls.append(1)
        if len(calls) == 4:  # the unit start factors nothing: pass 4
            ok = ok & torch.tensor([True, False, True])
        return L, Dinv, ok

    monkeypatch.setattr(dense, "ldl_factor", failing)
    solver = ct.BatchSolver(None, qs, A, bs, cones, device="cpu")
    got = solver.solve()
    assert solver.raw["scaling"].tolist() == [0, 1, 0]
    assert got[1].status == ct.SolverStatus.SOLVED
    for i in (0, 2):
        assert got[i].iterations == ref[i].iterations
        np.testing.assert_array_equal(got[i].x, ref[i].x)
