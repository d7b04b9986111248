"""Problem generators shared by the port's smoke run and tests."""

import numpy as np

from .cones.api import NonnegativeConeT, SecondOrderConeT, ZeroConeT


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
