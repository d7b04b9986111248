"""The port's f32 batched LDL^T on the CPU (cuclarabel_torch/kkt/ldl_f32.py:
the plain PyTorch versions that stand beside the Hopper kernels of
csrc/ldl_f32.cu) against the reference's Pallas kernels
(cuclarabel_tpu/kkt/pallas_ldl.py, interpret mode) and against numpy.

Shapes and inputs are those of tests/test_pallas_ldl.py: well-conditioned
quasidefinite K = [[P, A'], [A, -H]], B <= 5, N <= 16, plus B = 3 (the
batch the reference pads to 128 lanes).  Bars: the two f32 results agree
within 1e-5 relative to the largest entry (the same pivot-free
elimination, summed in another order by the reference's row-wise
substitution); and test_pallas_ldl.py's own numpy bars: reconstruction
of K within 1e-4 relative, the solve within 1e-2 of numpy f64, the
residual within 1e-3, and the inertia (n positive, m negative D)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuclarabel_tpu.kkt.pallas_ldl import (ldl_factor_batched as ref_factor,
                                           ldl_solve_batched as ref_solve)
import cuclarabel_torch as ct
from cuclarabel_torch.kkt import ldl, ldl_f32

TOL = 1e-5
# (B, n, m) of test_factor_reconstructs, test_solve_matches_numpy,
# test_inertia_matches_quasidefiniteness, test_nonaligned_batch_padding
SHAPES = [(5, 9, 7), (4, 8, 6), (3, 6, 5), (3, 5, 4)]
IDS = [f"B{B}-n{n}-m{m}" for B, n, m in SHAPES]


def _random_kkt_batch(rng, B, n, m):
    """tests/test_pallas_ldl.py::_random_kkt_batch, from a given rng."""
    Ks = []
    for _ in range(B):
        F = rng.standard_normal((n, n))
        P = F @ F.T + 0.1 * np.eye(n)
        A = rng.standard_normal((m, n))
        H = np.diag(rng.random(m) + 0.5)
        Ks.append(np.block([[P, A.T], [A, -H]]))
    return np.stack(Ks)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module", params=SHAPES, ids=IDS)
def case(request):
    """Inputs of one shape, the port's plain results and the reference
    kernels' results on the same f32 inputs."""
    B, n, m = request.param
    rng = np.random.default_rng(B * 100 + n * 10 + m)
    Ks = _random_kkt_batch(rng, B, n, m)
    K32 = Ks.astype(np.float32)
    b32 = rng.standard_normal((B, n + m)).astype(np.float32)
    L, Dinv = ct.ldl_factor_batched(torch.from_numpy(K32))
    x = ct.ldl_solve_batched(L, Dinv, torch.from_numpy(b32))
    Lr, Dr = ref_factor(jnp.asarray(K32), interpret=True)
    xr = ref_solve(Lr, Dr, jnp.asarray(b32), interpret=True)
    return {
        "n": n, "m": m, "K": Ks, "b": b32,
        "L": L.numpy(), "Dinv": Dinv.numpy(), "x": x.numpy(),
        "Lr": np.asarray(Lr), "Dr": np.asarray(Dr), "xr": np.asarray(xr),
    }


def test_factor_matches_reference(case):
    assert case["L"].dtype == case["Dinv"].dtype == np.float32
    assert _rel(np.tril(case["L"], -1), np.tril(case["Lr"], -1)) < TOL
    assert _rel(case["Dinv"], case["Dr"]) < TOL


def test_solve_matches_reference(case):
    assert case["x"].dtype == np.float32
    assert _rel(case["x"], case["xr"]) < TOL


def test_factor_reconstructs(case):
    N = case["n"] + case["m"]
    Ln = np.tril(case["L"].astype(np.float64), -1) + np.eye(N)
    D = 1.0 / case["Dinv"].astype(np.float64)
    for Ki, Li, Di in zip(case["K"], Ln, D):
        R = Li @ np.diag(Di) @ Li.T
        assert np.abs(R - Ki).max() / np.abs(Ki).max() < 1e-4
    # L holds the strict lower factor and nothing else
    assert not np.triu(case["L"]).any()


def test_solve_matches_numpy(case):
    for Ki, bi, xi in zip(case["K"], case["b"].astype(np.float64), case["x"]):
        expect = np.linalg.solve(Ki, bi)
        assert np.abs(xi - expect).max() < 1e-2  # f32 substitution
        assert np.abs(Ki @ xi - bi).max() < 1e-3


def test_inertia_matches_quasidefiniteness(case):
    D = 1.0 / case["Dinv"]
    assert np.all((D > 0).sum(axis=1) == case["n"])
    assert np.all((D < 0).sum(axis=1) == case["m"])


def test_reads_only_the_lower_triangle(case):
    """K's strict upper triangle is never read (symmetric K assumed)."""
    K = torch.from_numpy(case["K"].astype(np.float32))
    junk = K + torch.triu(torch.full_like(K, 7.0), 1)
    L, Dinv = ldl_f32.ldl_factor_batched(junk)
    np.testing.assert_array_equal(L.numpy(), case["L"])
    np.testing.assert_array_equal(Dinv.numpy(), case["Dinv"])


def test_plain_calls_counted_and_kernels_not():
    K = torch.from_numpy(_random_kkt_batch(np.random.default_rng(1), 2, 3, 2)
                         .astype(np.float32))
    ldl.reset_counts()
    L, Dinv = ct.ldl_factor_batched(K)
    ct.ldl_solve_batched(L, Dinv, torch.ones(2, 5))
    assert dict(ldl.PLAIN_CALLS) == {"ldl_factor_batched/r1": 1,
                                     "ldl_solve_batched/r1": 1}
    assert not ldl.LAUNCHES


def test_f32_only():
    """f32 in and out, as the reference: an f64 operand raises rather than
    run the factor in another precision."""
    K = torch.eye(4, dtype=torch.float64)[None]
    with pytest.raises(TypeError):
        ct.ldl_factor_batched(K)
    L, Dinv = ct.ldl_factor_batched(K.float())
    with pytest.raises(TypeError):
        ct.ldl_solve_batched(L, Dinv, torch.ones(1, 4, dtype=torch.float64))
    with pytest.raises(ValueError):  # any N >= 1 is taken (wide above 128)
        ct.ldl_factor_batched(torch.zeros(1, 0, 0))
