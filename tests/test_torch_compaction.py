"""Staged batch compaction and batch warm starts of the port's
BatchSolver (device="cpu") against its own plain path and against the
reference's BatchSolver on the same numpy problems: the cases of
tests/test_batch_compaction.py and tests/test_warm_start.py:80 (on one
device; the port has no n_devices > 1).

Bars: the reference tests' own (`_assert_matches`: the same status, the
objective within 1e-6 relative, x within 1e-5; chunked against
unchunked: the objective within 1e-9, x within 1e-8).  Against the
reference the port runs kkt_solve_method="lu", the reference's method on
the CPU, so that both take the same iterations and stage 1 stops on the
same loop pass: the compaction records must then be equal.  Batches are
held against batches of 8 and more, never at B = 4 (ROADMAP F2)."""

import dataclasses

import numpy as np
import pytest

import cuclarabel_tpu as cc
from cuclarabel_tpu.parallel import BatchSolver as RefBatchSolver
import cuclarabel_torch as ct
from test_batch_compaction import _assert_matches, _mixed_qp_batch
from test_batch_sharding import portfolio_batch
from test_warm_start import _qp as _warm_qp

LU = {"kkt_solve_method": "lu"}


def _port_cones(cones):
    return [getattr(ct, type(c).__name__)(**dataclasses.asdict(c))
            for c in cones]


def _port(data, **kw):
    P, q, A, b, cones = data
    return ct.BatchSolver(P, q, A, b, _port_cones(cones), device="cpu", **kw)


def _qp_ramp():
    return _mixed_qp_batch(16, 8, seed=3)


def _socp():
    A, qs, bs, cones = portfolio_batch(B=24, nass=16, seed=1)
    return None, qs, A, bs, cones


def _stack(sols):
    return tuple(np.stack([getattr(s, f) for s in sols])
                 for f in ("x", "s", "z"))


@pytest.mark.parametrize("make,quorum", [(_qp_ramp, 0.5), (_socp, 0.6)],
                         ids=["qp", "socp"])
def test_staged_matches_plain_and_reference(make, quorum):
    data = make()
    plain = _port(data, batch_compaction=0.0).solve()
    slv = _port(data, batch_compaction=quorum)
    staged = slv.solve()
    _assert_matches(plain, staged)
    for a, c in zip(plain, staged):
        assert a.iterations == c.iterations
    if make is _qp_ramp:
        # the conditioning ramp leaves a straggler tail: stage 2 ran
        assert slv.last_compaction["remainder"] > 0

    ref = RefBatchSolver(*data, batch_compaction=quorum)
    want = ref.solve()
    lu = _port(data, batch_compaction=quorum, **LU)
    got = lu.solve()
    _assert_matches(want, got)
    assert [s.iterations for s in got] == [s.iterations for s in want]
    assert lu.last_compaction == ref.last_compaction


def test_staged_preserves_certificates():
    """One primal-infeasible problem in an otherwise feasible batch."""
    P, q, A, b, cones = _mixed_qp_batch(8, 4, seed=5)
    A, b = A.copy(), b.copy()
    A[3] = np.vstack([-np.eye(4)[:2], np.eye(4)[:2]])
    b[3] = np.array([-1.0, -1.0, -1.0, -1.0])
    data = (P, q, A, b, cones)
    staged = _port(data, batch_compaction=0.5).solve()
    assert staged[3].status in (ct.SolverStatus.PRIMAL_INFEASIBLE,
                                ct.SolverStatus.ALMOST_PRIMAL_INFEASIBLE)
    for i in (0, 1, 2, 4, 5, 6, 7):
        assert staged[i].status == ct.SolverStatus.SOLVED
    want = RefBatchSolver(*data, batch_compaction=0.5).solve()
    assert ([s.status.name for s in staged]
            == [s.status.name for s in want])


def test_staged_warm_start():
    A, qs, bs, cones = portfolio_batch(B=8, nass=12, seed=2)
    data = (None, qs, A, bs, cones)
    slv = _port(data, batch_compaction=0.5)
    cold = slv.solve()
    warm = slv.solve(warm_start=_stack(cold))
    assert all(s.status == ct.SolverStatus.SOLVED for s in warm)
    assert max(s.iterations for s in warm) <= max(s.iterations for s in cold)

    ref = RefBatchSolver(*data, batch_compaction=0.5)
    want = ref.solve(warm_start=_stack(ref.solve()))
    lu = _port(data, batch_compaction=0.5, **LU)
    got = lu.solve(warm_start=_stack(lu.solve()))
    _assert_matches(want, got)
    assert [s.iterations for s in got] == [s.iterations for s in want]
    assert lu.last_compaction == ref.last_compaction


def test_compaction_setting_validation():
    with pytest.raises(ValueError):
        ct.Settings(batch_compaction=1.0).validate()
    with pytest.raises(ValueError):
        ct.Settings(batch_compaction=-0.1).validate()
    data = _mixed_qp_batch(8, 4)
    with pytest.raises(ValueError):
        _port(data, batch_compaction=0.5, n_devices=2)


@pytest.mark.parametrize("B,want", [(1023, 0.0), (1024, 0.9)])
def test_auto_compaction_resolves_as_the_reference(B, want):
    """Default settings compact at B >= 1024 and not below
    (settings.py: resolved_batch_compaction); the resolved value is kept
    in the solver's settings, as the reference keeps it."""
    P, q, A, b, cones = _mixed_qp_batch(1, 2)
    q, b = np.repeat(q, B, axis=0), np.repeat(b, B, axis=0)
    slv = _port((P[0], q, A[0], b, cones))
    assert slv.settings.batch_compaction == want
    ref = RefBatchSolver(P[0], q, A[0], b, cones)
    assert ref.settings.batch_compaction == want


@pytest.mark.parametrize("quorum", [0.0, 0.5])
def test_chunked_compaction_matches_unchunked(quorum):
    """batch_chunk_size x batch_compaction at B = 40, chunks of 16, 16
    and 8 (tests/test_batch_compaction.py:109)."""
    rng = np.random.default_rng(9)
    B, n = 40, 8
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    bs = np.tile(np.concatenate([[1.0], np.zeros(n)]), (B, 1))
    qs = rng.standard_normal((B, n))
    cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(n)]
    data = (None, qs, A, bs, cones)

    whole = _port(data, batch_chunk_size=0, batch_compaction=0.0).solve()
    slv = _port(data, batch_chunk_size=16, batch_compaction=quorum)
    assert slv._chunk == 16
    sols = slv.solve()
    assert slv.last_compaction["chunks"] == 3
    assert ("remainder" in slv.last_compaction) == (quorum > 0)
    for i in range(B):
        assert sols[i].status == ct.SolverStatus.SOLVED
        assert abs(sols[i].obj_val - whole[i].obj_val) < 1e-9, i
        np.testing.assert_allclose(sols[i].x, whole[i].x, atol=1e-8)

    want = RefBatchSolver(*data, batch_chunk_size=16,
                          batch_compaction=quorum).solve()
    got = _port(data, batch_chunk_size=16, batch_compaction=quorum,
                **LU).solve()
    for g, w in zip(got, want):
        assert g.status == ct.SolverStatus.SOLVED
        assert abs(g.obj_val - w.obj_val) < 1e-9
        np.testing.assert_allclose(g.x, w.x, atol=1e-8)


@pytest.mark.parametrize("quorum,chunk", [(0.0, 0), (0.5, 4)],
                         ids=["plain", "staged_chunked"])
def test_batch_warm_start_matches_reference(quorum, chunk):
    """tests/test_warm_start.py:80 on one device: after q *= 1.01 a warm
    re-solve from the previous solutions takes fewer iterations in total
    than a cold one, to the same objectives; the port's warm solve takes
    the reference's iterations with the same method."""
    P, q, A, b, cones = _warm_qp(n=20, seed=3)
    B = 8
    rng = np.random.default_rng(4)
    qb = np.broadcast_to(q, (B, len(q))) + 0.05 * rng.standard_normal(
        (B, len(q)))
    bb = np.broadcast_to(b, (B, len(b))).copy()
    data = (P, qb, A, bb, cones)
    kw = dict(batch_compaction=quorum, batch_chunk_size=chunk, **LU)
    slv = _port(data, **kw)
    sols = slv.solve()
    slv.update_data(q=qb * 1.01)
    warm = slv.solve(warm_start=_stack(sols))
    cold = slv.solve()
    assert all(s.status == ct.SolverStatus.SOLVED for s in warm)
    for w, c in zip(warm, cold):
        assert abs(w.obj_val - c.obj_val) < 1e-6
    assert sum(s.iterations for s in warm) < sum(s.iterations for s in cold)

    ref = RefBatchSolver(*data, **kw)
    prev = ref.solve()
    ref.update_data(q=qb * 1.01)
    want = ref.solve(warm_start=_stack(prev))
    _assert_matches(want, warm)
    assert [s.iterations for s in warm] == [s.iterations for s in want]


def test_batch_warm_start_with_B_equal_to_m():
    """B == m == 8, with the constraints x >= |b| active and P, q of
    problem k scaled by 10^(k-3), so that the cost scaling spans seven
    orders of magnitude over the batch and the duals are large: each
    problem's z must be scaled by its own cscale (cscale[:, None]),
    which a (B,)-vector broadcast over the rows of a (B, m) array would
    not do, silently, when m == B."""
    P, q, A, b, cones = _mixed_qp_batch(8, 8, seed=6)
    f = 10.0 ** np.arange(-3, 5)
    data = (P * f[:, None, None], (np.abs(q) + 1.0) * f[:, None], A, -b,
            cones)
    q = data[1]
    assert q.shape[0] == b.shape[1] == 8
    step = 1.0 + 0.01 * np.arange(8)[:, None]
    slv = _port(data, **LU)
    prev = slv.solve()
    slv.update_data(q=q * step)
    got = slv.solve(warm_start=_stack(prev))
    assert all(s.status == ct.SolverStatus.SOLVED for s in got)

    ref = RefBatchSolver(*data)
    ref_prev = ref.solve()
    ref.update_data(q=q * step)
    want = ref.solve(warm_start=_stack(ref_prev))
    _assert_matches(want, got)
    assert [s.iterations for s in got] == [s.iterations for s in want]
