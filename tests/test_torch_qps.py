"""The port's copy of the QPS reader/writer (cuclarabel_torch/qps.py)
against the reference's (cuclarabel_tpu/qps.py), and the AUG2D-class
grid QP through the port's SparseSolver.

Every QPS text of tests/test_qps.py (taken from that file with `ast`,
so the two stay in step), the transcribed Maros-Meszaros members of
benchmarks/maros.py and CVXQP1_S (benchmarks/cvxqp.py) parse to the same
QPSProblem on both sides, convert to the same conic data, and write the
same text; the copied grid generators (problems.make_grid_qp_qps,
grid_qp_reference) give the benchmarks' text and optimum.  Tolerance:
none (exact), except the grid QP's objective, within 1e-6 of the scipy
KKT solve (the reference test's bar)."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

from benchmarks import qps_corpus
from benchmarks.cvxqp import cvxqp_qps
from benchmarks.maros import PROBLEMS
from cuclarabel_tpu import qps as ref_qps
import cuclarabel_torch as ct
from cuclarabel_torch import problems, qps

ROOT = Path(__file__).resolve().parents[1]


def _texts():
    tree = ast.parse((ROOT / "tests" / "test_qps.py").read_text())
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and "ENDATA" in n.value]


TEXTS = _texts()


def _same_problem(a, b):
    assert (a.name, a.c0, a.maximize) == (b.name, b.c0, b.maximize)
    assert a.col_names == b.col_names and a.row_names == b.row_names
    for f in ("c", "rl", "ru", "lb", "ub"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for f in ("Q", "A"):
        np.testing.assert_array_equal(getattr(a, f).toarray(),
                                      getattr(b, f).toarray(), f)


def _same_conic(a, b):
    P, q, A, bb, cones, sgn_c0 = qps.to_clarabel(a)
    rP, rq, rA, rb, rcones, rsgn = ref_qps.to_clarabel(b)
    np.testing.assert_array_equal(P.toarray(), rP.toarray())
    np.testing.assert_array_equal(A.toarray(), rA.toarray())
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(bb, rb)
    assert sgn_c0 == rsgn
    assert [(type(c).__name__, c.dim) for c in cones] == \
        [(type(c).__name__, c.dim) for c in rcones]


def test_the_reference_texts_are_found():
    assert len(TEXTS) >= 6


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_parser_matches_reference(i):
    text = TEXTS[i]
    try:
        want = ref_qps.parse_qps(text)
    except ValueError as exc:
        with pytest.raises(ValueError, match=re.escape(str(exc))):
            qps.parse_qps(text)
        return
    got = qps.parse_qps(text)
    _same_problem(got, want)
    _same_conic(got, want)


@pytest.mark.parametrize("make", PROBLEMS, ids=lambda f: f.__name__)
def test_maros_members_round_trip(make, tmp_path):
    p = qps_corpus.maros_to_qps(make())
    mine, ref = tmp_path / "port.qps", tmp_path / "ref.qps"
    qps.write_qps(p, str(mine))
    ref_qps.write_qps(p, str(ref))
    assert mine.read_text() == ref.read_text()
    got, want = qps.load_qps(str(mine)), ref_qps.load_qps(str(ref))
    got.name = want.name
    _same_problem(got, want)
    _same_conic(got, want)


def test_cvxqp_s_parses_alike(tmp_path):
    path = tmp_path / "CVXQP1_S.qps"
    ref_qps.write_qps(cvxqp_qps("CVXQP1_S"), str(path))
    text = path.read_text()
    _same_problem(qps.parse_qps(text, name_hint="CVXQP1_S"),
                  ref_qps.parse_qps(text, name_hint="CVXQP1_S"))


@pytest.mark.parametrize("k", [3, 8])
def test_grid_generators_are_the_benchmarks(k):
    assert problems.make_grid_qp_qps(k) == qps_corpus.make_grid_qp_qps(k)
    assert problems.grid_qp_reference(k) == qps_corpus.grid_qp_reference(k)


def test_grid_qp_through_sparse_solver():
    """The AUG2D-class member at k = 8 (n = 112) through QPS text and the
    port's SparseSolver, against the exact KKT solve."""
    p = qps.parse_qps(problems.make_grid_qp_qps(8))
    P, q, A, b, cones, sgn_c0 = qps.to_clarabel(p)
    assert (q.shape[0], b.shape[0]) == (112, 63)
    sol = ct.SparseSolver(P, q, A, b, cones, device="cpu").solve()
    assert sol.status == ct.SolverStatus.SOLVED
    assert qps.qps_objective(sgn_c0, sol.obj_val) == pytest.approx(
        problems.grid_qp_reference(8), abs=1e-6)
