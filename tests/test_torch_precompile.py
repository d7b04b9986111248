"""The port's precompile() (tests/test_precompile.py's cases) on the
CPU: every family solves through the port's Solver, a signature is
solved once, and each workload's seconds come back by name; the
families' problems are the reference's."""

import importlib

import numpy as np
import pytest

import cuclarabel_torch as ct

# the packages export the function under the module's name
ref_pc = importlib.import_module("cuclarabel_tpu.precompile")
pc = importlib.import_module("cuclarabel_torch.precompile")


def test_families_and_a_signature():
    calls = []

    class Sig:
        def solve(self):
            calls.append(1)

    out = ct.precompile(device="cpu", signatures=[
        Sig(), lambda: ct.BatchSolver(None, np.ones((2, 1)), np.ones((1, 1)),
                                      np.ones((2, 1)),
                                      [ct.NonnegativeConeT(1)],
                                      device="cpu")])
    assert set(out) == set(pc._FAMILIES) | {"signature_0", "signature_1"}
    assert all(isinstance(v, float) and v >= 0.0 for v in out.values())
    assert calls == [1]


@pytest.mark.parametrize("name", sorted(ref_pc._FAMILIES))
def test_family_matches_reference(name):
    """Each family's problem is the reference's, and the port's Solver
    ends it SOLVED."""
    got = pc._FAMILIES[name]()
    want = ref_pc._FAMILIES[name]()
    for a, b in zip(got[:4], want[:4]):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)
    assert [type(c).__name__ for c in got[4]] == [
        type(c).__name__ for c in want[4]]
    for a, b in zip(got[4], want[4]):
        assert vars(a) == vars(b)
    sol = ct.Solver(*got, device="cpu").solve()
    assert sol.status == ct.SolverStatus.SOLVED


def test_subset_settings_and_verbose(capsys):
    out = pc.precompile(ct.Settings(max_iter=50), families=("qp", "sdp"),
                        verbose=True, device="cpu")
    assert list(out) == ["qp", "sdp"]
    printed = capsys.readouterr().out
    assert "precompile[qp]" in printed and "precompile[sdp]" in printed
