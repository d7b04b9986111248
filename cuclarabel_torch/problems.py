"""Problem generators shared by the port's smoke run and tests."""

import numpy as np

from .cones.api import (
    ExponentialConeT,
    GenPowerConeT,
    NonnegativeConeT,
    SecondOrderConeT,
    ZeroConeT,
)


def portfolio_socp(nass: int, batch: int, seed: int = 0):
    """Portfolio SOCP: min -mu'x + t  s.t. sum x = 1, x >= 0, t >= 0,
    (t; F'x) in SOC.  Returns (A, qs, bs, cones).  The same data, from
    the same seed, as the reference's `__graft_entry__._portfolio_socp`;
    nass = 32 gives n = 33, m = 43 and a KKT dimension of 76."""
    rng = np.random.default_rng(seed)
    n = nass + 1  # decision: (x, t)
    nfac = max(2, nass // 4)
    F = rng.standard_normal((nass, nfac))

    A_eq = np.zeros((1, n))
    A_eq[0, :nass] = 1.0
    A_nn = np.zeros((nass + 1, n))
    A_nn[:nass, :nass] = -np.eye(nass)
    A_nn[nass, nass] = -1.0
    A_soc = np.zeros((nfac + 1, n))
    A_soc[0, nass] = -1.0
    A_soc[1:, :nass] = -F.T
    A = np.vstack([A_eq, A_nn, A_soc])
    m = A.shape[0]

    qs = np.zeros((batch, n))
    bs = np.zeros((batch, m))
    for i in range(batch):
        mu = rng.standard_normal(nass) * 0.1
        qs[i] = np.concatenate([-mu, [1.0]])
        bs[i, 0] = 1.0
    cones = [
        ZeroConeT(1),
        NonnegativeConeT(nass + 1),
        SecondOrderConeT(nfac + 1),
    ]
    return A, qs, bs, cones


def exp_logistic(nfeat: int, nobs: int, batch: int, seed: int = 0):
    """Logistic-loss epigraphs through exponential cones: min sum t_i
    with softplus(-y_i w'x_i) <= t_i written as two exp-cone epigraphs
    per observation.  Returns (P, qs, A, bs, cones) in BatchSolver's
    order, A (batch, m, n) per problem.  Problem i draws (X, y) from
    default_rng(seed + i), as the reference suite's
    `benchmarks/suite.py::exp_logistic(nfeat, nobs, seed + i)` does, so
    problem 0 is that function's problem at `seed`.  nfeat = 4,
    nobs = 10 gives n = 34, m = 70 and a KKT dimension of 104."""
    nv = nfeat + 3 * nobs  # variables: w (nfeat), t, u, v (nobs each)
    m = nobs + 6 * nobs
    A = np.zeros((batch, m, nv))
    b = np.zeros(m)
    b[:nobs] = 1.0  # u + v <= 1
    b[nobs + 1::3] = 1.0  # the exp cones' middle rows
    for i in range(batch):
        rng = np.random.default_rng(seed + i)
        X = rng.standard_normal((nobs, nfeat))
        y = np.sign(rng.standard_normal(nobs))
        Ai = A[i]
        for k in range(nobs):
            Ai[k, nfeat + nobs + k] = 1.0
            Ai[k, nfeat + 2 * nobs + k] = 1.0
            r = nobs + 6 * k
            # (-y x'w - t, 1, u) in Kexp
            Ai[r, :nfeat] = y[k] * X[k]
            Ai[r, nfeat + k] = 1.0
            Ai[r + 2, nfeat + nobs + k] = 1.0
            # (-t, 1, v) in Kexp
            Ai[r + 3, nfeat + k] = 1.0
            Ai[r + 5, nfeat + 2 * nobs + k] = 1.0
    q = np.zeros(nv)
    q[nfeat:nfeat + nobs] = 1.0
    cones = ([NonnegativeConeT(nobs)]
             + [ExponentialConeT() for _ in range(2 * nobs)])
    return (1e-4 * np.eye(nv), np.tile(q, (batch, 1)), A,
            np.tile(b, (batch, 1)), cones)


def genpow_family(ncones: int, batch: int, seed: int = 0):
    """Generalised-power-cone family with an exact optimum: per cone j,
    maximise z_j with (w_j1, w_j2, z_j) in GenPow([a_j, 1 - a_j], 1) and
    the budget w_j1 + w_j2 = beta.  The reference suite's
    `benchmarks/suite.py::genpow_family(ncones, seed)`, its alpha grid
    drawn once from default_rng(seed); problem i has the budget
    beta_i = 1 + i / batch, so its optimum is
    -beta_i sum_j a_j^a_j (1 - a_j)^(1 - a_j).  Returns
    (P, qs, A, bs, cones, optima), P None; ncones = 8 gives n = 24,
    m = 32 and a KKT dimension of 56."""
    rng = np.random.default_rng(seed)
    grid = np.array([0.2, 0.35, 0.5, 0.65, 0.8])
    alphas = [float(rng.choice(grid)) for _ in range(ncones)]
    n = 3 * ncones
    A = np.zeros((ncones + n, n))
    q = np.zeros(n)
    for j in range(ncones):
        A[j, 3 * j] = A[j, 3 * j + 1] = 1.0  # the budget (zero cone)
        q[3 * j + 2] = -1.0
    A[ncones:] = -np.eye(n)
    beta = 1.0 + np.arange(batch) / batch
    bs = np.zeros((batch, ncones + n))
    bs[:, :ncones] = beta[:, None]
    cones = [ZeroConeT(ncones)] + [GenPowerConeT([a, 1.0 - a], 1)
                                   for a in alphas]
    per_beta = sum(a ** a * (1.0 - a) ** (1.0 - a) for a in alphas)
    return None, np.tile(q, (batch, 1)), A, bs, cones, -beta * per_beta
