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


# ---------------------------------------------------------------------
# the sparse paths' problems (copies: the originals live beside code
# that imports the JAX package)
# ---------------------------------------------------------------------

def grid_qp(k: int, seed=0):
    """min 1/2 x'Lx - q'x s.t. 0 <= x <= 1 on a k-by-k grid Laplacian
    (a copy of examples/sparse_and_sdp.py::grid_qp): n = k^2,
    m = 2 k^2, N_kkt = 3 k^2.  Returns (triu(L), q, A, b, cones), the
    matrices scipy.sparse."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n = k * k
    L = (sp.kronsum(sp.diags([[-1.0], [2.0], [-1.0]],
                             offsets=[-1, 0, 1], shape=(k, k)),
                    sp.diags([[-1.0], [2.0], [-1.0]],
                             offsets=[-1, 0, 1], shape=(k, k)))
         + 0.1 * sp.eye(n)).tocsc()
    q = -rng.random(n)
    A = sp.vstack([-sp.eye(n), sp.eye(n)]).tocsc()
    b = np.concatenate([np.zeros(n), np.ones(n)])
    return sp.triu(L).tocsc(), q, A, b, [NonnegativeConeT(2 * n)]


def make_grid_qp_qps(k: int, name: str = None) -> str:
    """AUG2D-class member: min (1/2)||x - t||^2 over edge variables of a
    k x k grid, subject to node flow-balance equalities — the
    'expanded system formulation of a 2-D PDE' structure of MM's AUG2D
    family, with a deterministic target t.  Returns QPS text (a copy of
    benchmarks/qps_corpus.py::make_grid_qp_qps: n = 2 k (k - 1),
    m = k^2 - 1).

    Being equality-constrained and strictly convex, the exact optimum
    is one sparse KKT solve (grid_qp_reference)."""
    nb = _grid_build(k)
    lines = [f"NAME          {name or f'GRIDQ{k}'}", "ROWS", " N  OBJ"]
    for i in range(nb["m"]):
        lines.append(f" E  C{i+1}")
    lines.append("COLUMNS")
    cols = nb["cols"]
    t = nb["t"]
    for j in range(nb["n"]):
        lines.append(f"    E{j+1}  OBJ  {float(-t[j])!r}")
        for (i, v) in cols[j]:
            lines.append(f"    E{j+1}  C{i+1}  {float(v)!r}")
    lines.append("RHS")
    lines.append(f"    RHS  OBJ  {-(0.5 * float(t @ t))!r}")
    for i, v in enumerate(nb["b"]):
        if v != 0.0:
            lines.append(f"    RHS  C{i+1}  {float(v)!r}")
    lines.append("BOUNDS")
    for j in range(nb["n"]):
        lines.append(f" FR BND  E{j+1}")
    lines.append("QUADOBJ")
    for j in range(nb["n"]):
        lines.append(f"    E{j+1}  E{j+1}  1.0")
    lines.append("ENDATA")
    return "\n".join(lines) + "\n"


def _grid_build(k: int):
    """Edge-incidence structure of a k x k grid with deterministic
    target and supplies."""
    idx = lambda r, c: r * k + c  # noqa: E731
    edges = []
    for r in range(k):
        for c in range(k):
            if c + 1 < k:
                edges.append((idx(r, c), idx(r, c + 1)))
            if r + 1 < k:
                edges.append((idx(r, c), idx(r + 1, c)))
    n = len(edges)
    m = k * k - 1  # drop the last node row (incidence is rank m)
    cols = [[] for _ in range(n)]
    for j, (u, v) in enumerate(edges):
        if u < m:
            cols[j].append((u, 1.0))
        if v < m:
            cols[j].append((v, -1.0))
    # deterministic target + balanced supplies
    t = np.sin(0.7 * np.arange(1, n + 1)) * 2.0
    b = np.cos(1.3 * np.arange(1, m + 1))
    return {"n": n, "m": m, "cols": cols, "t": t, "b": b}


def grid_qp_reference(k: int) -> float:
    """Exact optimum of make_grid_qp_qps(k) via one sparse KKT solve
    (scipy's spsolve on the host)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    nb = _grid_build(k)
    n, m = nb["n"], nb["m"]
    rows, colsj, vals = [], [], []
    for j, entries in enumerate(nb["cols"]):
        for (i, v) in entries:
            rows.append(i)
            colsj.append(j)
            vals.append(v)
    A = sp.coo_matrix((vals, (rows, colsj)), shape=(m, n)).tocsc()
    t, b = nb["t"], nb["b"]
    KKT = sp.bmat([[sp.eye(n), A.T], [A, None]], format="csc")
    rhs = np.concatenate([t, b])
    sol = spla.spsolve(KKT, rhs)
    x = sol[:n]
    return float(0.5 * x @ x - t @ x + 0.5 * t @ t)


def grid_qp_family(k: int, batch: int, seed: int = 0,
                   vary_values: bool = False):
    """A batch over grid_qp(k)'s pattern for BatchSparseSolver: q scaled
    per problem by 1 + 0.2 N(0, 1) entrywise and the upper bounds drawn
    from [1, 1.5); with vary_values, P's diagonal scaled by [1, 1.5)
    (P stays diagonally dominant) and A's values by [0.5, 1.5) per
    problem.  Returns (P, qs, A, bs, cones, P_vals, A_vals), the values
    None without vary_values, else (B, nnz) over SparseProblem's COO
    order of triu(P) and A."""
    import scipy.sparse as sp

    P, q, A, b, cones = grid_qp(k, seed)
    rng = np.random.default_rng(seed + 1)
    n = q.shape[0]
    qs = q * (1.0 + 0.2 * rng.standard_normal((batch, n)))
    bs = np.concatenate([np.zeros((batch, n)),
                         1.0 + 0.5 * rng.random((batch, n))], axis=1)
    P_vals = A_vals = None
    if vary_values:
        Pu = sp.triu(sp.csc_matrix(P)).tocoo()
        scale = np.where(Pu.row == Pu.col,
                         1.0 + 0.5 * rng.random((batch, Pu.nnz)), 1.0)
        P_vals = Pu.data[None, :] * scale
        Ac = sp.coo_matrix(A)
        A_vals = Ac.data[None, :] * (0.5 + rng.random((batch, Ac.nnz)))
    return P, qs, A, bs, cones, P_vals, A_vals


def socp_golden():
    """The SOCP golden of tests/test_basic_socp.py (copied): objective
    -0.8459 (BASELINE.md).  Returns (P, q, A, b, cones)."""
    P = np.array([
        [1.4652521089139698, 0.6137176286085666, -1.1527861771130112],
        [0.6137176286085666, 2.219109946678485, -1.4400420548730628],
        [-1.1527861771130112, -1.4400420548730628, 1.6014483534926371]])
    A_box = np.vstack([np.eye(3), -np.eye(3)]) * 2.0
    return (P, np.array([0.1, -2.0, 1.0]), np.vstack([A_box, np.eye(3)]),
            np.concatenate([np.ones(6), np.zeros(3)]),
            [NonnegativeConeT(3), NonnegativeConeT(3), SecondOrderConeT(3)])


def box_budget_qp(n: int, m_in: int, seed: int = 0):
    """The box-and-budget QP of `scripts/arrow_scaling.py::make_qp`: n
    variables, one budget equality sum(x) = 1 and m_in nonnegative rows
    (the box -1 <= x <= 1, then m_in - 2n random cuts g'x <= 2 with
    g ~ N(0, I/n)), P = F F' + 0.1 I with F (n, n/4).  The same draws
    and values as the script's, with A (1 + m_in, n) filled in place, so
    that a large instance holds one copy of A.  -> (P, q, A, b, cones)."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, max(2, n // 4)))
    P = F @ F.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n) * 0.1
    A = np.empty((1 + m_in, n))
    A[0] = 1.0
    A[1:n + 1] = np.eye(n)
    A[n + 1:2 * n + 1] = -np.eye(n)
    cuts = A[2 * n + 1:]
    rng.standard_normal(out=cuts)
    cuts /= np.sqrt(n)
    b = np.concatenate([[1.0], np.ones(2 * n), np.full(m_in - 2 * n, 2.0)])
    return P, q, A, b, [ZeroConeT(1), NonnegativeConeT(m_in)]


def sharded_socp(n: int = 40, seed: int = 0):
    """The problem of tests/test_sharded_single.py::make_problem (the
    same draws): a QP with P = F F' + 0.1 I, 8 equality rows, n
    nonnegative rows and one second-order cone of dim 8.
    -> (P, q, A, b, cones)."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, 8))
    P = F @ F.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    meq = 8
    Aeq = rng.standard_normal((meq, n))
    beq = Aeq @ rng.standard_normal(n)
    nfac = 7
    Fs = rng.standard_normal((n, nfac))
    A_soc = np.zeros((nfac + 1, n))
    A_soc[1:, :] = -Fs.T
    b_soc = np.zeros(nfac + 1)
    b_soc[0] = 3.0
    A = np.vstack([Aeq, -np.eye(n), A_soc])
    b = np.concatenate([beq, np.zeros(n) + 3.0, b_soc])
    return P, q, A, b, [ZeroConeT(meq), NonnegativeConeT(n),
                        SecondOrderConeT(nfac + 1)]


def portfolio_model(nass: int, seed: int = 7, **model_kw):
    """Problem 0 of portfolio_socp(nass, 1, seed) written through the
    modeling layer: one variable vector x, min q'x, and each cone's rows
    as the membership b_k - A_k x in K_k (A x + s = b, s in K).  The
    Model assembles exactly that (A, b).  model_kw go to Model (settings
    fields, device).  -> (model, x, (A, q, b, cones))."""
    from .modeling import Model

    A, qs, bs, cones = portfolio_socp(nass, 1, seed)
    q, b = qs[0], bs[0]
    model = Model(**model_kw)
    x = model.add_variables(A.shape[1])
    lo = 0
    for cone in cones:
        hi = lo + cone.dim
        model.add_constraint(b[lo:hi] - A[lo:hi] @ x, cone)
        lo = hi
    model.minimize(q @ x)
    return model, x, (A, q, b, cones)
