"""cuclarabel_torch.solve_digest off the card: its digest changes with
any bit of x, s or z and with nothing else, and its entry point needs a
CUDA device."""

import numpy as np
import pytest
import torch

import cuclarabel_torch as ct
from cuclarabel_torch import solve_digest
from cuclarabel_torch.problems import portfolio_socp


@pytest.fixture(scope="module")
def sols():
    A, q, b, cones = portfolio_socp(nass=4, batch=3, seed=7)
    return ct.BatchSolver(None, q, A, b, cones, device="cpu").solve()


def test_digest_is_bitwise(sols):
    d = solve_digest.digest(sols)
    assert d == solve_digest.digest(sols)
    assert d["statuses"] == ["SOLVED"] and len(d["iterations"]) == 3
    for field in ("x", "s", "z"):
        v = getattr(sols[1], field)
        old = v[0]
        v[0] = np.nextafter(old, np.inf)  # one bit
        assert solve_digest.digest(sols)["sha256"] != d["sha256"], field
        v[0] = old
    assert solve_digest.digest(sols) == d


def test_main_needs_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert solve_digest.main() == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_psd_paths_run_on_the_cpu():
    """The PSD digest paths build and solve (device="cpu" here, at a
    small size): each gives solutions to digest."""
    from cuclarabel_torch import problems

    small = {"maxcut_sdp": lambda nv, B, seed: problems.maxcut_sdp(
        4, 3, seed), "sdp_chordal_banded": lambda nv, bw, seed:
        problems.sdp_chordal_banded(6, bw, seed)}

    class Pr:
        def __getattr__(self, name):
            return small.get(name, getattr(problems, name))

    class CpuCt:
        def BatchSolver(self, *a, **k):
            return ct.BatchSolver(*a, device="cpu", **k)

        def Solver(self, *a, **k):
            return ct.Solver(*a, device="cpu", **k)

    for path, make in solve_digest.PSD_PATHS:
        d = solve_digest.digest(make(CpuCt(), Pr()))
        assert d["statuses"] == ["SOLVED"], path


def test_sparse_paths_run_on_the_cpu():
    """The sparse digest paths build and solve (device="cpu" here, at a
    small size): each gives SOLVED solutions to digest."""
    from cuclarabel_torch import problems

    small = {"grid_qp": lambda k: problems.grid_qp(4),
             "grid_qp_family": lambda k, B, seed: problems.grid_qp_family(
                 4, 3, seed)}

    class Pr:
        def __getattr__(self, name):
            return small.get(name, getattr(problems, name))

    class CpuCt:
        def __getattr__(self, name):
            return lambda *a, **k: getattr(ct, name)(*a, device="cpu", **k)

    for path, make in solve_digest.SPARSE_PATHS:
        d = solve_digest.digest(make(CpuCt(), Pr()))
        assert d["statuses"] == ["SOLVED"], path


def test_wide_paths_run_on_the_cpu():
    """The digest paths above N = 128 build and solve (device="cpu" here,
    at B = 3): each gives SOLVED solutions to digest, and the Solver's
    problem is the batch's first."""
    from cuclarabel_torch import problems

    class Pr:
        def portfolio_socp(self, nass, batch, seed):
            return problems.portfolio_socp(nass, min(batch, 3), seed=seed)

    class CpuCt:
        def __getattr__(self, name):
            return lambda *a, **k: getattr(ct, name)(*a, device="cpu", **k)

    got = {path: make(CpuCt(), Pr()) for path, make, _ in
           solve_digest.WIDE_PATHS}
    for path, sols in got.items():
        assert solve_digest.digest(sols)["statuses"] == ["SOLVED"], path
    batch, one = got["batch_wide_n148_B256"], got["solver_wide_n148"]
    assert len(batch) == 3 and len(one) == 1
    assert abs(batch[0].obj_val - one[0].obj_val) <= 1e-7 * abs(
        one[0].obj_val)
