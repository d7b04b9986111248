"""The port's dense KKT backend (cuclarabel_torch/kkt/dense.py) on the
CPU, where the "pallas" method runs the LDL^T kernels' plain versions:
solutions against numpy f64 solves of the unregularised K within 1e-9
relative (tests/test_pallas_dd.py:502) for every method ("pallas", "lu",
"qr", "inverse"), and the 2-RHS pair solve against two single solves."""

import numpy as np
import pytest
import torch

from cuclarabel_torch.cones.api import (
    NonnegativeConeT,
    SecondOrderConeT,
    ZeroConeT,
)
from cuclarabel_torch.cones import ops
from cuclarabel_torch.cones.layout import build_layout
from cuclarabel_torch.kkt import ldl
from cuclarabel_torch.kkt.dense import make_dense_kkt, resolve_kkt_method
from cuclarabel_torch.settings import Settings

B, n = 4, 6
CONES = (ZeroConeT(2), NonnegativeConeT(5), SecondOrderConeT(4))
LAYOUT = build_layout(CONES)
m = LAYOUT.m
TOL = 1e-9


def _interior(rng):
    v = rng.uniform(0.2, 2.0, (B, m))
    lo, hi = LAYOUT.ranges[2]
    v[:, lo + 1:hi] = rng.standard_normal((B, hi - lo - 1))
    v[:, lo] = np.linalg.norm(v[:, lo + 1:hi], axis=1) + 0.5
    return v


@pytest.fixture(scope="module")
def system():
    """Batched KKT data with an Hs from a real scaling point, spread by
    a per-problem factor 10^(+-3) as late in an IPM."""
    rng = np.random.default_rng(21)
    G = rng.standard_normal((B, n, n))
    P = G @ G.transpose(0, 2, 1) / n
    A = rng.standard_normal((B, m, n))
    s, z = _interior(rng), _interior(rng)
    scal, ok = ops.update_scaling(LAYOUT, torch.tensor(s), torch.tensor(z),
                                  None, 0)
    assert bool(ok.all())
    Hs = ops.assemble_Hs_dense(LAYOUT, scal).numpy()
    Hs *= 10.0 ** rng.uniform(-3, 3, (B, 1, 1))
    rx = rng.standard_normal((B, n))
    rz = rng.standard_normal((B, m))
    K = np.block([[P, A.transpose(0, 2, 1)], [A, -Hs]])
    return {"P": P, "A": A, "Hs": Hs, "rx": rx, "rz": rz, "K": K, "rng": rng}


def _solve(method, system, **kw):
    st = Settings(kkt_solve_method=method, **kw)
    factorize, solve = make_dense_kkt(n, m, st, LAYOUT, device="cpu")
    t = {k: torch.tensor(system[k]) for k in ("P", "A", "Hs", "rx", "rz")}
    fac, okf = factorize(t["P"], t["A"], t["Hs"])
    return factorize, solve, fac, okf, t


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("method", ["pallas", "lu", "qr", "inverse"])
def test_solve_matches_numpy(system, method):
    _, solve, fac, okf, t = _solve(method, system)
    x, z, ok, nir = solve(fac, t["rx"], t["rz"])
    rhs = np.concatenate([system["rx"], system["rz"]], axis=1)
    want = np.linalg.solve(system["K"], rhs[..., None])[..., 0]
    got = torch.cat([x, z], dim=1).numpy()
    assert bool(okf.all()) and bool(ok.all())
    assert nir.shape == (B,)
    assert _rel(got, want) < TOL


def test_solve_without_refinement_matches_regularised_numpy(system):
    """With refinement off the answer is the factored system's: K plus
    the signed static regularisation eps = const + prop * max|diag K|."""
    st = Settings()
    _, solve, fac, okf, t = _solve("pallas", system,
                                   iterative_refinement_enable=False)
    x, z, ok, nir = solve(fac, t["rx"], t["rz"])
    K = system["K"]
    dK = np.abs(np.diagonal(K, axis1=1, axis2=2)).max(axis=1)
    eps = (st.static_regularization_constant
           + st.static_regularization_proportional * dK)
    dsigns = np.concatenate([np.ones(n), -np.ones(m)])
    Kreg = K + eps[:, None, None] * np.diag(dsigns)
    rhs = np.concatenate([system["rx"], system["rz"]], axis=1)
    want = np.linalg.solve(Kreg, rhs[..., None])[..., 0]
    assert bool(ok.all()) and int(nir.max()) == 0
    assert _rel(torch.cat([x, z], dim=1).numpy(), want) < TOL


def test_pair_solve_matches_two_single_solves(system):
    _, solve, fac, _, t = _solve("pallas", system)
    rng = system["rng"]
    rx2 = torch.tensor(rng.standard_normal((B, n)))
    rz2 = torch.tensor(rng.standard_normal((B, m)))
    x1, z1, x2, z2, ok, nir = solve.pair(fac, t["rx"], t["rz"], rx2, rz2)
    s1 = solve(fac, t["rx"], t["rz"])
    s2 = solve(fac, rx2, rz2)
    assert bool(ok.all())
    for got, want in ((x1, s1[0]), (z1, s1[1]), (x2, s2[0]), (z2, s2[1])):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-13)
    assert torch.equal(nir, torch.maximum(s1[3], s2[3]))


def test_pallas_path_runs_plain_versions_on_cpu(system):
    ldl.reset_counts()
    _, solve, fac, _, t = _solve("pallas", system)
    solve(fac, t["rx"], t["rz"])
    assert not ldl.LAUNCHES
    assert ldl.PLAIN_CALLS["ldl_factor/r1"] == 1
    assert ldl.PLAIN_CALLS["ldl_solve_refine/r1"] == 1


def test_resolve_kkt_method():
    st = Settings()
    assert resolve_kkt_method(st, 76) == "pallas"
    assert resolve_kkt_method(st, 128) == "pallas"
    assert resolve_kkt_method(st, 129) == "lu"
    for method in ("lu", "qr", "inverse"):
        assert resolve_kkt_method(st.replace(kkt_solve_method=method),
                                  200) == method
    # explicit "pallas" runs the kernels at any N (their wide forms above
    # 128), as the reference's does; "auto" keeps "lu" above 128
    for N in (129, 148, 292):
        assert resolve_kkt_method(st.replace(kkt_solve_method="pallas"),
                                  N) == "pallas"
