"""Problem generators shared by the port's smoke run and tests."""

import numpy as np

from .cones.api import (
    ExponentialConeT,
    GenPowerConeT,
    NonnegativeConeT,
    PSDTriangleConeT,
    SecondOrderConeT,
    ZeroConeT,
)


def svec(M) -> np.ndarray:
    """The svec of a symmetric matrix: its upper triangle column by
    column, off-diagonal entries times sqrt(2) (the PSD cones' storage,
    `cones/psd.py`)."""
    d = M.shape[0]
    return np.array([M[i, j] * (1.0 if i == j else np.sqrt(2.0))
                     for j in range(d) for i in range(j + 1)])


def smat(v, d: int) -> np.ndarray:
    """The symmetric (d, d) matrix of an svec."""
    M = np.zeros((d, d))
    a = 0
    for j in range(d):
        for i in range(j + 1):
            M[i, j] = M[j, i] = v[a] / (1.0 if i == j else np.sqrt(2.0))
            a += 1
    return M


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


def maxcut_sdp(nv: int, batch: int, seed: int = 0):
    """Goemans-Williamson max-cut SDP relaxations in their dual form:
    min sum(y) s.t. Diag(y) - L/4 in the PSD cone, written as
    s = b - A y with A's columns -svec(E_ii) (shared) and b = svec(-L/4),
    L the weighted Laplacian of an Erdos-Renyi graph on nv vertices (edge
    probability 0.5, weights uniform on [0, 1)) drawn from
    default_rng(seed + i) for problem i.  The optimum is the relaxation's
    bound on the cut; the primal certificate is X = mat(z) with
    diag(X) = 1, X PSD and <L/4, X> = sum(y).  Returns (P, qs, A, bs,
    cones, laplacians), P None; nv = 12 gives n = 12, m = 78 and a KKT
    dimension of 90."""
    sd = nv * (nv + 1) // 2
    A = np.zeros((sd, nv))
    for i in range(nv):
        A[:, i] = -svec(np.diag(np.eye(nv)[i]))
    Ls = np.zeros((batch, nv, nv))
    for i in range(batch):
        rng = np.random.default_rng(seed + i)
        W = np.triu((rng.random((nv, nv)) < 0.5) * rng.random((nv, nv)), 1)
        W = W + W.T
        Ls[i] = np.diag(W.sum(1)) - W
    bs = np.stack([svec(-L / 4.0) for L in Ls])
    return (None, np.ones((batch, nv)), A, bs, [PSDTriangleConeT(nv)], Ls)


def psd_min_eig(d: int, batch: int, seed: int = 0):
    """min tr(C X) s.t. tr X = 1, X in the PSD cone, whose optimum is
    lambda_min(C): the reference's batched PSD family
    (tests/test_batch_sharding.py::test_batch_psd_matches_single), C of
    problem i the symmetric part of the i-th standard normal (d, d) draw
    of default_rng(seed).  Returns (P, qs, A, bs, cones, optima), P None;
    d = 8 gives n = 36, m = 37 and a KKT dimension of 73."""
    rng = np.random.default_rng(seed)
    sd = d * (d + 1) // 2
    Cs = [(lambda M: (M + M.T) / 2)(rng.standard_normal((d, d)))
          for _ in range(batch)]
    qs = np.stack([svec(C) for C in Cs])
    A = np.vstack([svec(np.eye(d))[None, :], -np.eye(sd)])
    bs = np.tile(np.concatenate([[1.0], np.zeros(sd)]), (batch, 1))
    optima = np.array([np.linalg.eigvalsh(C)[0] for C in Cs])
    return None, qs, A, bs, [ZeroConeT(1), PSDTriangleConeT(d)], optima


def sdp_chordal_banded(nv: int, bw: int, seed: int):
    """min tr(C X) s.t. X_ij = M_ij on the off-diagonal band, X
    PSD-completable: the cone rows touch only the band's svec entries,
    so chordal decomposition splits the cone into a chain of cliques.
    The reference suite's `benchmarks/suite.py::sdp_chordal_banded`,
    returning its data (P, q, A, b, cones), P None, instead of solving.
    With the Solver's default settings (compact decomposition) nv = 11,
    bw = 2 gives a KKT dimension of 127, nv = 12 one of 141."""
    rng = np.random.default_rng(seed)
    sd = nv * (nv + 1) // 2
    band_idx, diag_flag = [], []
    a = 0
    for j in range(nv):
        for i in range(j + 1):
            if j - i <= bw:
                band_idx.append(a)
                diag_flag.append(i == j)
            a += 1
    ny = len(band_idx)
    q = np.zeros(ny)
    rows, bs = [], []
    for t in range(ny):
        if diag_flag[t]:
            q[t] = rng.random() + 0.5       # tr(C X) on the diagonal
        else:
            r = np.zeros(ny)
            r[t] = 1.0
            rows.append(r)
            bs.append(0.3 * np.sqrt(2.0) * (0.5 + 0.1 * (t % 5)))
    Apsd = np.zeros((sd, ny))
    for t, bi in enumerate(band_idx):
        Apsd[bi, t] = -1.0
    A = np.vstack([np.vstack(rows), Apsd])
    b = np.concatenate([np.asarray(bs), np.zeros(sd)])
    return None, q, A, b, [ZeroConeT(len(rows)), PSDTriangleConeT(nv)]
