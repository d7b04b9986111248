"""Goemans-Williamson max-cut relaxations (J. ACM 42, 1995) in their
dual form, as `problems.maxcut_sdp` of the port states it:

    min sum(y)   s.t.  Diag(y) - L/4 in the PSD cone

written s = b - A y with A's columns -svec(E_ii) (shared by every
problem) and b = svec(-L/4), L the weighted Laplacian of an Erdos-Renyi
graph on nv vertices, edge probability 0.5, weights uniform on [0, 1).
Each batch draws fresh graphs, one per problem.
"""

import numpy as np

from . import svec


def structure(cfg):
    nv = cfg["nv"]
    A = -svec(np.eye(nv)[:, None, :] * np.eye(nv)[:, :, None]).T
    return {"n": nv, "m": A.shape[0], "A": A, "P": None,
            "cones": [("psd", nv)]}


def batch(cfg, struct, rng, B):
    nv = cfg["nv"]
    p = cfg.get("edge_probability", 0.5)
    W = np.triu((rng.random((B, nv, nv)) < p) * rng.random((B, nv, nv)), 1)
    W = W + np.transpose(W, (0, 2, 1))
    L = -W
    idx = np.arange(nv)
    L[:, idx, idx] = W.sum(axis=2)
    return {"q": np.ones((B, nv)), "b": svec(-L / 4.0)}
