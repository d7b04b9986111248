"""The port's LDL^T engine on the CPU (cuclarabel_torch/kkt/ldl.py: the
plain PyTorch versions that stand beside the Hopper kernels) against the
reference's double-float Pallas kernels (cuclarabel_tpu/kkt/pallas_dd.py,
interpret mode, default variants) and against numpy f64.

Tolerances: the reference's own bars in tests/test_pallas_dd.py —
1e-9 relative for factors and solutions (:77, :315, :502) and 1e-11 for
the refined solve's returned residual against b - K x recomputed (:542).
The reference works in (hi, lo) f32 pairs (~2^-48), the port in f64, so
they agree to rounding, not bit for bit.  Each reference kernel is
traced once per N in a module-scoped fixture (interpret mode costs
seconds per trace)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuclarabel_tpu.kkt.pallas_dd import (
    dd_ldl_factor,
    dd_ldl_solve,
    dd_ldl_solve_refine,
    dd_ldl_solve_refine_r,
    dd_residual,
    join_f64,
    split_f64,
)
from cuclarabel_torch.interop import factor_from_reference
from cuclarabel_torch.kkt import ldl

B = 3
TOL = 1e-9
TOL_RETURNED_R = 1e-11
# npass of the reference's refined solves, per N: together {0, 1, 2};
# N = 129 and 148 take the kernels' wide forms on the card (N > 128)
REF_NPASS = {12: (1, 0), 13: (2, 1), 129: (0, 2), 148: (2, 1)}  # (r = 1, 2)
# Hs spread of the N > 128 cases, as tests/test_torch_cuda.py draws it:
# over their 124-143 constraint rows a spread of 10^(+-4) puts the
# smallest Hs near 1e-4, where a refinement pass against the
# unregularised K gains only reg / Hs ~ 1e-4, and the reference's own
# refined x is then 5.3e-9 from K^-1 b after one pass (N = 129), above
# the 1e-9 bar, as the port's is; the sums of |K x| ~ 1e4 part by 4e-12
# between summation orders.  The small cases' 7-8 rows rarely reach it.
WIDE_SPREAD = 3.0


def _make_kkt(rng, n, m, spread=4.0):
    """Quasidefinite K in the dense backend's stability order (the
    inequality block first, kkt/dense.py), Hs spread 10^(+-spread), and
    the signed static regularisation as the reference kernels take it
    (f32)."""
    N = n + m
    A = rng.standard_normal((B, m, n))
    G = rng.standard_normal((n, n)) / np.sqrt(n)
    Hs = 10.0 ** rng.uniform(-spread, spread, (B, m))
    K = np.zeros((B, N, N))
    K[:, :m, :m] = -Hs[:, :, None] * np.eye(m)
    K[:, :m, m:] = A
    K[:, m:, :m] = np.transpose(A, (0, 2, 1))
    K[:, m:, m:] = G @ G.T
    dsigns = np.concatenate([-np.ones(m), np.ones(n)])
    reg = np.broadcast_to(dsigns * 1e-8, (B, N)).astype(np.float32)
    return K, reg.astype(np.float64)


def _lane(x):  # (B, ...) -> (..., B)
    return jnp.moveaxis(jnp.asarray(x), 0, -1)


def _unlane(x):  # (..., B) -> (B, ...)
    return np.moveaxis(np.asarray(x), -1, 0)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _rel(a, b, floor=1.0):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), floor)


@pytest.fixture(scope="module", params=[12, 13, 129, 148],
                ids=["N12", "N13", "N129", "N148"])
def case(request):
    """Inputs of one N and the reference kernels' outputs on them."""
    N = request.param
    n = 5
    m = N - n
    rng = np.random.default_rng(100 + N)
    K, reg = _make_kkt(rng, n, m, spread=WIDE_SPREAD if N > 128 else 4.0)
    b1 = rng.standard_normal((B, N))
    b2 = rng.standard_normal((B, N, 2))
    x0 = rng.standard_normal((B, N))
    np1, np2 = REF_NPASS[N]

    Kh, Kl = split_f64(_lane(K))
    regT = _lane(reg).astype(jnp.float32)
    Lh, Ll, Dh, Dl = dd_ldl_factor(Kh, Kl, regT, interpret=True)
    bh, bl = split_f64(_lane(b1))
    x0h, x0l = split_f64(_lane(x0))
    b2h, b2l = split_f64(jnp.moveaxis(jnp.asarray(b2), 0, -1))
    xs = dd_ldl_solve(Lh, Ll, Dh, Dl, bh, bl, interpret=True)
    rs = dd_residual(Kh, Kl, x0h, x0l, bh, bl, interpret=True)
    xr1 = dd_ldl_solve_refine(Kh, Kl, Lh, Ll, Dh, Dl, bh, bl, npass=np1,
                              interpret=True)
    xr2 = dd_ldl_solve_refine_r(Kh, Kl, Lh, Ll, Dh, Dl, b2h, b2l,
                                npass=np2, interpret=True)
    Kreg = K + np.einsum("bi,ij->bij", reg, np.eye(N))
    return {
        "N": N, "K": K, "reg": reg, "b1": b1, "b2": b2, "x0": x0,
        "npass": (np1, np2),
        "ref_factor": (Lh, Ll, Dh, Dl),
        "ref_solve": _unlane(join_f64(*xs)),
        "ref_resid": _unlane(join_f64(*rs)),
        "ref_refine1": tuple(_unlane(join_f64(h, l))
                             for h, l in (xr1[:2], xr1[2:])),
        "ref_refine2": tuple(_unlane(join_f64(h, l))
                             for h, l in (xr2[:2], xr2[2:])),
        # numpy f64 solutions of the regularised and unregularised K
        "np_reg": lambda b: np.linalg.solve(Kreg, b.reshape(B, N, -1)
                                            ).reshape(b.shape),
        "np_unreg": lambda b: np.linalg.solve(K, b.reshape(B, N, -1)
                                              ).reshape(b.shape),
    }


def _port_factor(case):
    return ldl.ldl_factor(_t(case["K"]), _t(case["reg"]))


def test_factor_matches_reference(case):
    L, Dinv, ok = _port_factor(case)
    Lr, Dr = factor_from_reference(*case["ref_factor"])
    assert bool(ok.all())
    assert np.all(np.triu(L.numpy()) == 0.0)  # strictly lower, zeros above
    assert _rel(L.numpy(), Lr, 0.0) < TOL
    assert _rel(Dinv.numpy(), Dr, 0.0) < TOL


def test_factor_reconstructs_K(case):
    """(I + L) D (I + L)' = K + diag(reg) in f64."""
    L, Dinv, _ = _port_factor(case)
    N = case["N"]
    U = L.numpy() + np.eye(N)
    M = U @ (U.transpose(0, 2, 1) / Dinv.numpy()[:, :, None])
    Kreg = case["K"] + np.einsum("bi,ij->bij", case["reg"], np.eye(N))
    assert _rel(M, Kreg, 0.0) < 1e-13


def test_solve_matches_reference_and_numpy(case):
    L, Dinv, _ = _port_factor(case)
    b = case["b1"]
    x = ldl.ldl_solve(L, Dinv, _t(b)).numpy()
    assert _rel(x, case["ref_solve"]) < TOL
    assert _rel(x, case["np_reg"](b)) < TOL


def test_solve_on_reference_factor(case):
    """The port's substitution on the reference's own factor (hi + lo)
    reproduces the reference's substitution."""
    Lr, Dr = factor_from_reference(*case["ref_factor"])
    x = ldl.ldl_solve(_t(Lr), _t(Dr), _t(case["b1"])).numpy()
    assert _rel(x, case["ref_solve"]) < TOL


def test_residual_matches_reference(case):
    K, x0, b = case["K"], case["x0"], case["b1"]
    r = ldl.kkt_residual(_t(K), _t(x0), _t(b)).numpy()
    r_np = b - np.einsum("bij,bj->bi", K, x0)
    assert _rel(r, case["ref_resid"]) < TOL
    assert _rel(r, r_np) < 1e-13


def test_residual_reads_the_lower_triangle(case):
    """kkt_residual takes a symmetric K and reads only its lower
    triangle, as its kernel does: with junk above the diagonal, r is
    b - sym(K) x, the r of the symmetric K."""
    K, x0, b = case["K"], case["x0"], case["b1"]
    rng = np.random.default_rng(7)
    Kj = K + np.triu(rng.standard_normal(K.shape), 1) * 1e3
    r = ldl.kkt_residual(_t(Kj), _t(x0), _t(b)).numpy()
    Ks = np.tril(Kj) + np.transpose(np.tril(Kj, -1), (0, 2, 1))
    assert np.array_equal(r, ldl.kkt_residual(_t(K), _t(x0), _t(b)).numpy())
    assert _rel(r, b - np.einsum("bij,bj->bi", Ks, x0)) < 1e-13
    assert _rel(r, case["ref_resid"]) < TOL


@pytest.mark.parametrize("npass", [0, 1, 2])
@pytest.mark.parametrize("R", [1, 2])
def test_refine_returns_true_residual(case, R, npass):
    """x solves K (npass >= 1: the unregularised K the refinement runs
    against; npass = 0: the factored K + diag(reg)) to the bar, and the
    returned r is b - K x of the returned x."""
    L, Dinv, _ = _port_factor(case)
    K = case["K"]
    b = case["b1"] if R == 1 else case["b2"]
    x, r = ldl.ldl_solve_refine(_t(K), L, Dinv, _t(b), npass)
    x, r = x.numpy(), r.numpy()
    xr = x.reshape(B, case["N"], -1)
    r_true = b - (K @ xr).reshape(b.shape)
    assert np.abs(r - r_true).max() < TOL_RETURNED_R
    want = case["np_reg"](b) if npass == 0 else case["np_unreg"](b)
    assert _rel(x, want) < TOL


@pytest.mark.parametrize("R", [1, 2])
def test_refine_matches_reference(case, R):
    L, Dinv, _ = _port_factor(case)
    npass = case["npass"][R - 1]
    b = case["b1"] if R == 1 else case["b2"]
    x, r = ldl.ldl_solve_refine(_t(case["K"]), L, Dinv, _t(b), npass)
    xref, rref = case[f"ref_refine{R}"]
    if R == 2:  # the reference's (N, r, B) -> (B, N, r)
        assert xref.shape == (B, case["N"], 2)
    assert _rel(x.numpy(), xref) < TOL
    assert _rel(r.numpy(), rref) < TOL


@pytest.mark.parametrize("npass", [0, 1, 2])
def test_two_rhs_equal_two_single_solves(case, npass):
    L, Dinv, _ = _port_factor(case)
    K, b2 = _t(case["K"]), _t(case["b2"])
    x2 = ldl.ldl_solve(L, Dinv, b2)
    r2 = ldl.kkt_residual(K, x2, b2)
    xf2, rf2 = ldl.ldl_solve_refine(K, L, Dinv, b2, npass)
    for t in range(2):
        bt = b2[:, :, t].contiguous()
        x1 = ldl.ldl_solve(L, Dinv, bt)
        r1 = ldl.kkt_residual(K, x2[:, :, t].contiguous(), bt)
        xf1, rf1 = ldl.ldl_solve_refine(K, L, Dinv, bt, npass)
        torch.testing.assert_close(x2[:, :, t], x1, rtol=0, atol=0)
        torch.testing.assert_close(r2[:, :, t], r1, rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(xf2[:, :, t], xf1, rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(rf2[:, :, t], rf1, rtol=1e-12, atol=1e-14)


def test_cpu_path_counts_plain_calls(case):
    ldl.reset_counts()
    L, Dinv, _ = _port_factor(case)
    ldl.ldl_solve_refine(_t(case["K"]), L, Dinv, _t(case["b2"]), 1)
    assert not ldl.LAUNCHES
    assert ldl.PLAIN_CALLS == {"ldl_factor/r1": 1, "ldl_solve_refine/r2": 1}


def test_kkt_residual_exact_is_exact():
    """kkt_residual_exact, the yardstick of the smoke's returned-residual
    check, against exact rational arithmetic: within one ulp of the
    exact b - K x of K's lower triangle."""
    from fractions import Fraction

    from chip_smoke import kkt_residual_exact

    rng = np.random.default_rng(3)
    B, N = 3, 9
    K = rng.standard_normal((B, N, N)) * 10.0 ** rng.uniform(-4, 4, (B, N, N))
    x = rng.standard_normal((B, N)) * 1e4
    b = rng.standard_normal((B, N))
    Ks = np.tril(K) + np.transpose(np.tril(K, -1), (0, 2, 1))
    got = kkt_residual_exact(torch.tensor(K), torch.tensor(x),
                             torch.tensor(b)).numpy()
    for i in range(B):
        for r in range(N):
            exact = Fraction(b[i, r]) - sum(
                Fraction(Ks[i, r, j]) * Fraction(x[i, j]) for j in range(N))
            want = float(exact)
            assert abs(got[i, r] - want) <= np.spacing(abs(want)), (i, r)
