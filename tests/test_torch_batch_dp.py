"""The port's data-parallel BatchSolver and BatchSparseSolver
(n_devices > 1, every slab on the CPU, one host thread each) against
one-device batches of each slab and against the reference's sharded
batches on the 8 virtual CPU devices of tests/conftest.py.

Bars: slab i's results bitwise equal to a one-device batch of slab i
alone at the same settings (status, iterations, x, s and z); statuses
and iterations equal to the reference's sharded batch under "lu" on
both sides, at B = 6 (n_devices 2 and 3) and B = 8 (n_devices 8), so
that no reference slab is 4 wide (ROADMAP F2); the sparse batch (the
reference's is one GSPMD-sharded vmap, no slab of 4 either) with x
within 1e-7."""

import numpy as np
import pytest

import cuclarabel_tpu as cc
from cuclarabel_tpu.parallel import BatchSolver as RefBatchSolver
from cuclarabel_tpu.parallel import BatchSparseSolver as RefBatchSparse
from __graft_entry__ import _portfolio_socp
import cuclarabel_torch as ct
from cuclarabel_torch.interop import cones_from_reference
from cuclarabel_torch.problems import portfolio_socp
from tests.test_sparse_batch import _grid_family

# (n_devices, B): slabs of 3, 2 and 1
WIDTHS = ((2, 6), (3, 6), (8, 8))
FIELDS = ("x", "s", "z")
TOL_X = 1e-7


def _portfolio(mod, B, seed=3):
    make = _portfolio_socp if mod is cc else portfolio_socp
    A, q, b, cones = make(nass=4, batch=B, seed=seed)
    return None, q, A, b, cones


def _same(got, want):
    """Bitwise equal results, problem by problem."""
    assert [s.status for s in got] == [s.status for s in want]
    assert [s.iterations for s in got] == [s.iterations for s in want]
    for g, w in zip(got, want):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def _slabs_alone(make, B, ndev, **kw):
    """One-device batches of each slab, concatenated."""
    out = []
    w = B // ndev
    for i in range(ndev):
        out += make(slice(i * w, (i + 1) * w), **kw).solve()
    return out


def _dense_slab(P, q, A, b, cones):
    def make(sl, **kw):
        return ct.BatchSolver(P, q[sl], A, b[sl], cones, device="cpu", **kw)
    return make


@pytest.mark.parametrize("ndev,B", WIDTHS)
def test_batch_slabs_equal_one_device_batches(ndev, B):
    P, q, A, b, cones = _portfolio(ct, B)
    solver = ct.BatchSolver(P, q, A, b, cones, n_devices=ndev, device="cpu")
    assert len(solver.devices) == ndev
    got = solver.solve()
    assert all(s.status == ct.SolverStatus.SOLVED for s in got)
    _same(got, _slabs_alone(_dense_slab(P, q, A, b, cones), B, ndev,
                            batch_compaction=0.0))


@pytest.mark.parametrize("ndev,B", WIDTHS)
def test_batch_matches_reference_sharded_batch(ndev, B):
    want = RefBatchSolver(*_portfolio(cc, B), n_devices=ndev,
                          kkt_solve_method="lu").solve()
    got = ct.BatchSolver(*_portfolio(ct, B), n_devices=ndev, device="cpu",
                         kkt_solve_method="lu").solve()
    assert [s.status.name for s in got] == [s.status.name for s in want]
    assert [s.iterations for s in got] == [s.iterations for s in want]
    for g, w in zip(got, want):
        assert abs(g.obj_val - w.obj_val) <= 1e-7 * max(1.0, abs(w.obj_val))


def test_batch_warm_start_and_update_data():
    """update_data and a warm start split across the slabs exactly as a
    one-device batch of each slab takes them."""
    ndev, B = 3, 6
    P, q, A, b, cones = _portfolio(ct, B)
    solver = ct.BatchSolver(P, q, A, b, cones, n_devices=ndev, device="cpu")
    cold = solver.solve()
    q2 = 1.01 * q
    solver.update_data(q=q2)
    ws = tuple(np.stack([getattr(s, f) for s in cold]) for f in FIELDS)
    warm = solver.solve(warm_start=ws)
    assert all(s.status == ct.SolverStatus.SOLVED for s in warm)
    want = []
    w = B // ndev
    for i in range(ndev):
        sl = slice(i * w, (i + 1) * w)
        one = ct.BatchSolver(P, q2[sl], A, b[sl], cones, device="cpu")
        want += one.solve(warm_start=tuple(x[sl] for x in ws))
    _same(warm, want)
    fresh = ct.BatchSolver(P, q2, A, b, cones, device="cpu").solve()
    assert sum(s.iterations for s in warm) < sum(s.iterations
                                                  for s in fresh)


def test_batch_options_resolve_and_raise():
    P, q, A, b, cones = _portfolio(ct, 8)
    # auto compaction (0.9 at B >= 1024 on one device) and auto chunking
    # resolve to 0 over several devices
    solver = ct.BatchSolver(P, q[:8], A, b[:8], cones, n_devices=2,
                            device="cpu", batch_compaction_min_batch=4,
                            batch_chunk_size=-1)
    assert solver.settings.batch_compaction == 0.0 and solver._chunk == 0
    one = ct.BatchSolver(P, q[:8], A, b[:8], cones, device="cpu",
                         batch_compaction_min_batch=4)
    assert one.settings.batch_compaction == 0.9
    with pytest.raises(ValueError, match="batch_compaction"):
        ct.BatchSolver(P, q[:8], A, b[:8], cones, n_devices=2, device="cpu",
                       batch_compaction=0.5)
    with pytest.raises(ValueError, match="divide evenly"):
        ct.BatchSolver(P, q[:7], A, b[:7], cones, n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="n_devices"):
        ct.BatchSolver(P, q[:8], A, b[:8], cones, n_devices=0, device="cpu")


def test_slab_errors_are_raised_again():
    """An exception in a slab's thread reaches the caller."""
    from cuclarabel_torch.parallel.slabs import run_slabs

    import torch

    def boom():
        raise FloatingPointError("slab 1")

    cpu = torch.device("cpu")
    with pytest.raises(FloatingPointError, match="slab 1"):
        run_slabs([cpu, cpu, cpu], [lambda: 0, boom, lambda: 2])
    assert run_slabs([cpu, cpu], [lambda: 0, lambda: 1]) == [0, 1]


def _sparse_family(B, seed=2):
    P, qs, A, bs, cones, _, _ = _grid_family(k=4, B=B, seed=seed)
    return P, qs, A, bs, cones


@pytest.mark.parametrize("ndev,B", WIDTHS)
def test_sparse_batch_slabs_equal_one_device_batches(ndev, B):
    P, qs, A, bs, cones = _sparse_family(B)
    ccones = cones_from_reference(cones)
    solver = ct.BatchSparseSolver(P, qs, A, bs, ccones, n_devices=ndev,
                                  device="cpu")
    got = solver.solve()
    assert all(s.status == ct.SolverStatus.SOLVED for s in got)
    want = []
    w = B // ndev
    for i in range(ndev):
        sl = slice(i * w, (i + 1) * w)
        want += ct.BatchSparseSolver(P, qs[sl], A, bs[sl], ccones,
                                     device="cpu").solve()
    _same(got, want)
    ref = RefBatchSparse(P, qs, A, bs, cones, n_devices=ndev).solve()
    assert [s.status.name for s in got] == [s.status.name for s in ref]
    assert [s.iterations for s in got] == [s.iterations for s in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.x, r.x, rtol=0, atol=TOL_X)


def test_sparse_batch_warm_start_and_update_data():
    ndev, B = 2, 6
    P, qs, A, bs, cones = _sparse_family(B, seed=5)
    ccones = cones_from_reference(cones)
    solver = ct.BatchSparseSolver(P, qs, A, bs, ccones, n_devices=ndev,
                                  device="cpu")
    cold = solver.solve()
    # one symbolic analysis for both devices' index maps
    assert len([k for k in solver._sp._kkt_memo if len(k) == 2]) == 1
    qs2 = qs + 0.05
    solver.update_data(q=qs2)
    ws = tuple(np.stack([getattr(s, f) for s in cold]) for f in FIELDS)
    warm = solver.solve(warm_start=ws)
    assert all(s.status == ct.SolverStatus.SOLVED for s in warm)
    want = []
    for i in range(ndev):
        sl = slice(i * 3, (i + 1) * 3)
        want += ct.BatchSparseSolver(P, qs2[sl], A, bs[sl], ccones,
                                     device="cpu").solve(
            warm_start=tuple(x[sl] for x in ws))
    _same(warm, want)
    with pytest.raises(ValueError, match="divide evenly"):
        ct.BatchSparseSolver(P, qs[:5], A, bs[:5], ccones, n_devices=2,
                             device="cpu")


def test_launch_counts_exact_under_threads():
    """kkt/ldl.py's Counts, which the kernels' wrappers bump from one
    host thread per card: no update lost with 32 threads switching every
    microsecond, and the per-device counts sum to the total."""
    import sys
    import threading

    from cuclarabel_torch.kkt.ldl import Counts

    counts = Counts()

    def bump(i):
        for _ in range(2000):
            counts.add("ldl_factor/r1", f"cuda:{i % 4}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump, args=(i,))
                   for i in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["ldl_factor/r1"] == 64000
    assert {k: v["ldl_factor/r1"] for k, v in counts.by_device.items()} == {
        f"cuda:{i}": 16000 for i in range(4)}
    counts.clear()
    assert not counts and not counts.by_device
