"""The port's Solver (device="cpu") on problems with PSD triangle cones,
against the reference's Solver on the same numpy data.

Problems: the goldens of tests/test_basic_sdp.py (BASELINE.md's SDP,
obj 4.840076866013861; with an empty PSD cone beside it; the mixed
NN + SOC + PSD problem), tests/test_sdp_chordal.py's PSD + power cone
problem under all 12 chordal settings (compact x complete_dual x merge
method), `problems.sdp_chordal_banded(nv, 2, 6)` at nv = 10, 11 (KKT
dimension 113 and 127, the kernels' path) and 12 (141, "lu"), and
tests/test_qr_backend.py's nearest-PSD projection at nv = 24 (N = 600)
under "lu" and "qr".  The reference runs "lu" (its interpret-mode
"pallas" takes about a minute a problem here).  Bars: SOLVED, the
reference's objective within 1e-7 relative and its iterations, within
one where the port's "pallas" (its plain LDL^T on the CPU) meets the
reference's "lu"."""

import itertools

import numpy as np
import pytest

import cuclarabel_tpu as cc
import cuclarabel_torch as ct
from cuclarabel_torch import interop
from cuclarabel_torch.kkt.dense import refines_regularised
from cuclarabel_torch.problems import sdp_chordal_banded
from tests.test_basic_sdp import basic_sdp_data
from tests.test_qr_backend import _psd_projection
from tests.test_sdp_chordal import sdp_chordal_data

TOL_OBJ = 1e-7
GOLDEN_OBJ = 4.840076866013861
COMBOS = list(itertools.product(
    [False, True], [False, True], ["clique_graph", "parent_child", "none"]))


def _mixed_sdp_socp():
    """tests/test_basic_sdp.py::test_mixed_sdp_socp's problem (copied:
    the data is built inside that test)."""
    rng = np.random.default_rng(42)
    n = 6
    F = rng.standard_normal((n, n))
    P = F @ F.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A_soc = np.zeros((3, n))
    A_soc[1, 0] = A_soc[2, 1] = -1.0
    A_psd = np.zeros((3, n))
    A_psd[0, 0] = A_psd[2, 1] = -1.0
    A_psd[1, 2] = -np.sqrt(2.0)
    A = np.vstack([np.eye(n), A_soc, A_psd])
    b = np.concatenate([np.full(n, 2.0), [1.5, 0.0, 0.0], [1.0, 0.0, 1.0]])
    return P, q, A, b, [cc.NonnegativeConeT(n), cc.SecondOrderConeT(3),
                        cc.PSDTriangleConeT(2)]


def _empty_psd():
    P, q, A, b, cones = basic_sdp_data()
    return P, q, A, b, cones + [cc.PSDTriangleConeT(0)]


def _banded(nv):
    def data():
        _, q, A, b, cones = sdp_chordal_banded(nv, 2, 6)
        return (None, q, A, b, [cc.ZeroConeT(cones[0].dim),
                                cc.PSDTriangleConeT(nv)])
    return data


PROBLEMS = {
    "sdp": basic_sdp_data,
    "sdp_empty_cone": _empty_psd,
    "mixed_sdp_socp": _mixed_sdp_socp,
    "banded10": _banded(10),
    "banded11": _banded(11),
    "banded12": _banded(12),
}


def _pair(data, method, **kw):
    P, q, A, b, cones = data
    port = ct.Solver(P, q, A, b, interop.cones_from_reference(cones),
                     device="cpu", kkt_solve_method=method, **kw)
    ref = cc.Solver(P, q, A, b, cones, kkt_solve_method="lu", **kw)
    return port, port.solve(), ref, ref.solve()


def _hold(got, want, method, what):
    assert got.status == ct.SolverStatus.SOLVED, what
    assert want.status == cc.SolverStatus.SOLVED, what
    err = abs(got.obj_val - want.obj_val) / abs(want.obj_val)
    assert err <= TOL_OBJ, (what, err)
    slack = 1 if method == "pallas" else 0
    assert abs(got.iterations - want.iterations) <= slack, (
        what, got.iterations, want.iterations)
    assert got.x.shape == want.x.shape and got.z.shape == want.z.shape


# banded12 is decomposed to N = 141, past the kernels' 128: "lu" only
CASES = [(name, method) for name in sorted(PROBLEMS)
         for method in ("pallas", "lu")
         if (name, method) != ("banded12", "pallas")]


@pytest.mark.parametrize("name,method", CASES)
def test_matches_reference(name, method):
    data = PROBLEMS[name]()
    N = len(data[1]) + len(data[3])
    port, got, _, want = _pair(data, method)
    _hold(got, want, method, name)
    if name in ("sdp", "sdp_empty_cone"):
        assert abs(got.obj_val - GOLDEN_OBJ) < 1e-7
    if name.startswith("banded"):
        assert port.chordal_info is not None
        # compact decomposition: 2 more columns per overlap, 3 x 3 cliques
        assert port.n + port.m > N


def test_banded_rows_take_the_resolved_methods():
    """Decomposed, nv = 11 stays on the kernels (N = 127) and nv = 12
    goes past them (N = 141) to "lu", as resolve_kkt_method chooses."""
    for nv, N, method in ((11, 127, "pallas"), (12, 141, "lu")):
        _, q, A, b, cones = sdp_chordal_banded(nv, 2, 6)
        solver = ct.Solver(None, q, A, b, cones, device="cpu")
        solver.solve()
        info = solver.get_info()["linear_solver"]
        assert (info["kkt_dim"], info["method"]) == (N, method)


@pytest.mark.parametrize("combo", COMBOS,
                         ids=["-".join(map(str, c)) for c in COMBOS])
def test_chordal_sweep_matches_reference(combo):
    compact, complete_dual, merge = combo
    kw = dict(chordal_decomposition_compact=compact,
              chordal_decomposition_complete_dual=complete_dual,
              chordal_decomposition_merge_method=merge)
    P, q, A, b, cones = sdp_chordal_data()
    port, got, ref, want = _pair((P, q, A, b, cones), "pallas", **kw)
    assert (port.chordal_info is None) == (ref.chordal_info is None)
    if merge == "none":
        assert port.chordal_info is not None
    _hold(got, want, "pallas", str(combo))
    # the original problem's full-length solution, primal feasible
    assert (len(got.x), len(got.s), len(got.z)) == (8, 28, 28)
    assert np.linalg.norm(A @ got.x + got.s - b) < 1e-6


@pytest.mark.parametrize("method", ["lu", "qr"])
def test_psd_projection(method):
    """tests/test_qr_backend.py's nv = 24 projection (N = 600) under the
    library methods: SOLVED to 1e-9 residuals, the reference's
    objective and iterations."""
    P, q, A, b, cones, M = _psd_projection()
    port, got, _, want = _pair((P, q, A, b, cones), method)
    _hold(got, want, method, f"psd projection {method}")
    assert got.r_prim < 1e-9 and got.r_dual < 1e-9
    assert port.get_info()["linear_solver"]["method"] == method


def test_refinement_rule_follows_the_layout():
    """A layout of PSD cones alone keeps the reference's refinement
    towards the unregularised K; PSD beside power cones (a nonsymmetric
    layout) refines towards the regularised K, as the exp cones do."""
    from cuclarabel_torch.cones.layout import build_layout

    P, q, A, b, cones = sdp_chordal_data()
    mixed = build_layout(tuple(interop.cones_from_reference(cones)))
    pure = build_layout((ct.ZeroConeT(1), ct.PSDTriangleConeT(3)))
    assert mixed.has_nonsymmetric and refines_regularised(mixed)
    assert pure.is_symmetric and not refines_regularised(pure)


def test_init_follows_the_layout():
    """A layout of zero and PSD cones without P starts from the symmetric
    LP init (one 2-RHS refined solve, K2r on the card); PSD beside power
    cones starts from the cones' unit points, with no such solve."""
    from cuclarabel_torch.kkt import ldl

    for data, pairs in ((_banded(10)(), 1), (sdp_chordal_data(), 0)):
        P, q, A, b, cones = data
        ldl.reset_counts()
        sol = ct.Solver(P, q, A, b, interop.cones_from_reference(cones),
                        device="cpu").solve()
        assert sol.status == ct.SolverStatus.SOLVED
        assert ldl.PLAIN_CALLS["ldl_solve_refine/r2"] == pairs


def test_update_guard_with_chordal_decomposition():
    P, q, A, b, cones = sdp_chordal_data()
    solver = ct.Solver(P, q, A, b, interop.cones_from_reference(cones),
                       device="cpu", chordal_decomposition_merge_method="none")
    assert solver.chordal_info is not None
    assert not solver.is_data_update_allowed()
    with pytest.raises(ValueError, match="chordal decomposition is active"):
        solver.update_q(q)
    sol = solver.solve()
    with pytest.raises(ValueError, match="chordal decomposition is active"):
        solver.solve(warm_start=(sol.x, sol.s, sol.z))
    off = ct.Solver(P, q, A, b, interop.cones_from_reference(cones),
                    device="cpu", chordal_decomposition_enable=False)
    assert off.chordal_info is None and off.is_data_update_allowed()
    assert "chordal" in solver.timers["setup"]


@pytest.mark.parametrize("method", ["pallas", "lu"])
def test_warm_started_resolve(method):
    """update_q, then a re-solve warm-started from the previous solution:
    SOLVED in fewer iterations than cold, with the reference's warm
    objective and iterations (within one under "pallas")."""
    P, q, A, b, cones = basic_sdp_data()
    q = q + 0.1
    port = ct.Solver(P, q, A, b, interop.cones_from_reference(cones),
                     device="cpu", kkt_solve_method=method)
    ref = cc.Solver(P, q, A, b, cones, kkt_solve_method="lu")
    sol, rsol = port.solve(), ref.solve()
    q2 = q + 1e-3 * np.arange(len(q))
    for s in (port, ref):
        s.update_q(q2)
    warm = port.solve(warm_start=(sol.x, sol.s, sol.z))
    rwarm = ref.solve(warm_start=(rsol.x, rsol.s, rsol.z))
    cold = port.solve()
    _hold(warm, rwarm, method, "warm")
    assert warm.iterations < cold.iterations
    assert abs(warm.obj_val - cold.obj_val) < 1e-7
