"""The factor-model Markowitz portfolio SOCP (MOSEK Portfolio
Optimization Cookbook, section 3.3), as `problems.portfolio_socp` of the
port states it:

    min -mu'x + t   s.t.  sum x = 1,  x >= 0,  t >= 0,  (t, F'x) in SOC

x the nass weights, F (nass, nfac) the factor loadings with
nfac = max(2, nass // 4).  F is the deployment's risk model: drawn once
from the configuration's structure_seed (the same draw as
`portfolio_socp(nass, B, seed=structure_seed)`), so every run solves
against one model.  Each batch draws fresh expected returns
mu ~ 0.1 N(0, 1), one row per problem.
"""

import numpy as np


def structure(cfg):
    nass = cfg["nass"]
    nfac = max(2, nass // 4)
    F = np.random.default_rng(cfg["structure_seed"]).standard_normal(
        (nass, nfac))
    n = nass + 1
    A = np.zeros((1 + nass + 1 + nfac + 1, n))
    A[0, :nass] = 1.0
    A[1:1 + nass, :nass] = -np.eye(nass)
    A[1 + nass, nass] = -1.0
    A[2 + nass, nass] = -1.0
    A[3 + nass:, :nass] = -F.T
    cones = [("zero", 1), ("nonneg", nass + 1), ("soc", nfac + 1)]
    return {"n": n, "m": A.shape[0], "A": A, "P": None, "cones": cones}


def batch(cfg, struct, rng, B):
    nass = cfg["nass"]
    q = np.ones((B, struct["n"]))
    q[:, :nass] = -0.1 * rng.standard_normal((B, nass))
    b = np.zeros((B, struct["m"]))
    b[:, 0] = 1.0
    return {"q": q, "b": b}
