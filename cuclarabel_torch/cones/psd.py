"""PSD triangle cones, batched over problems and over the cones of one
side length.

The counterpart of `cuclarabel_tpu/cones/psd.py` (reference
`src/cones/coneops_psdtrianglecone.jl`).  Cones are grouped by side
length r (`layout.psd_groups`: r -> (k, sd) index matrix, sd =
r(r+1)/2); each group runs batched decompositions over (B, k, r, r)
stacks: `torch.linalg.cholesky_ex`, `svd`, `eigh` and `eigvalsh`, the
library routines that the reference leaves to XLA too.  Per-cone
scalars are (B, k) and per-problem results (B,): every reduction that
the reference makes within one problem runs here over every axis but the
batch axis.

svec storage is the scaled upper triangle in column-major order with
sqrt(2) off the diagonal (svec_to_mat!/mat_to_svec!,
coneops_psdtrianglecone.jl:469-497), so <svec(X), svec(Y)> = <X, Y>_F.

NT scaling (update_scaling!, coneops_psdtrianglecone.jl:78-143):
L1 = chol(S), L2 = chol(Z), SVD(L2' L1) = U Sigma V', lambda = diag
Sigma, R = L1 V Sigma^{-1/2}, Rinv = Sigma^{-1/2} U' L2', and the KKT
block Hs = skron(R R') (skron!, coneops_psdtrianglecone.jl:502-540).
The SVD's U and V are not unique (at the identity start L2' L1 = I), so
R and Rinv may differ from the reference's while R R', Rinv' Rinv,
lambda, Hs, the step lengths and the barrier agree.

A factor that fails (a point outside the cone) is zeroed and reported
through `ok`, never raised: `cholesky_ex(check_errors=False)` takes the
place of the reference's NaN factors and `where(isfinite)`.

The composite entry points take the index plan `p` of `cones/ops.py`,
whose `psd_groups` holds one `Group` per side length.
"""

import functools

import numpy as np
import torch

from .nonsymmetric import BIG

FMAX = float(np.finfo(np.float64).max)
ISQRT2 = 1.0 / np.sqrt(2.0)
SQRT2 = float(np.sqrt(2.0))


@functools.lru_cache(maxsize=64)
def _tri_maps(r: int):
    """Static numpy index maps for side length r:
    (rows, cols): (sd,) matrix coordinates of each svec entry
    (row <= col); diagpos: svec positions of the diagonal; matidx:
    (r, r) svec position of (i, j), symmetrised; scale_mat: (r, r)
    svec -> mat scaling (1 on the diagonal, 1/sqrt2 off it); cvec: (sd,)
    1 on the diagonal, sqrt2 off it."""
    rows, cols = [], []
    for j in range(r):
        for i in range(j + 1):
            rows.append(i)
            cols.append(j)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    sd = len(rows)
    diagpos = np.nonzero(rows == cols)[0]
    matidx = np.zeros((r, r), np.int64)
    for a in range(sd):
        matidx[rows[a], cols[a]] = a
        matidx[cols[a], rows[a]] = a
    scale_mat = np.full((r, r), ISQRT2)
    np.fill_diagonal(scale_mat, 1.0)
    cvec = np.where(rows == cols, 1.0, SQRT2)
    return rows, cols, diagpos, matidx, scale_mat, cvec


class Group:
    """The index plan of the layout's PSD cones of side r on one device:
    idx (k, sd) rows of each cone in the (m,) vectors, `flat` its
    flattening, `diag_flat` the rows of the cones' diagonals (k * r),
    `hs_flat` the positions of their (sd, sd) Hs blocks in a flattened
    (m, m) matrix, and _tri_maps(r) as tensors."""

    def __init__(self, r: int, idx: np.ndarray, m: int, device):
        t = functools.partial(torch.as_tensor, device=device)
        rows, cols, diagpos, matidx, scale_mat, cvec = _tri_maps(r)
        idx = idx.astype(np.int64)
        self.r, self.k, self.sd = r, idx.shape[0], idx.shape[1]
        self.idx = t(idx)
        self.flat = t(idx.ravel())
        self.diag_flat = t(idx[:, diagpos].ravel())
        self.hs_flat = t((idx[:, :, None] * m + idx[:, None, :]).ravel())
        self.rows, self.cols = t(rows), t(cols)
        self.diagpos = t(diagpos)
        self.matidx = t(matidx)
        self.scale_mat = t(scale_mat, dtype=torch.float64)
        self.cvec = t(cvec, dtype=torch.float64)
        self.is_diag = t(rows == cols)


def svec_to_mat(x, g: Group):
    """(..., sd) -> (..., r, r) symmetric matrices."""
    return x[..., g.matidx] * g.scale_mat


def mat_to_svec(M, g: Group):
    """(..., r, r) -> (..., sd); symmetrises like mat_to_svec!."""
    vals = (M[..., g.rows, g.cols] + M[..., g.cols, g.rows]) * 0.5
    return torch.where(g.is_diag, vals, vals * SQRT2)


def _gather(v, g: Group):
    """The group's cones of the (B, m) vector v, as (B, k, sd)."""
    return v[:, g.idx]


def _scatter(out, g: Group, vals):
    """out[:, rows of the group] = vals (B, k, sd), out of place."""
    return out.index_copy(1, g.flat, vals.reshape(out.shape[0], -1))


def _cholesky(M):
    """(L, ok) of a (B, k, r, r) stack: ok (B, k) where the factor
    succeeded with finite entries, and L zeroed where it did not."""
    L, info = torch.linalg.cholesky_ex(M, check_errors=False)
    ok = (info == 0) & torch.isfinite(L).flatten(-2).all(dim=-1)
    return torch.where(ok[..., None, None], L, 0.0), ok


def _chol_logdet(M):
    """(logdet, ok), each (B, k), via Cholesky; ok false where M is not
    positive definite."""
    L, ok = _cholesky(M)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = ok & (d > 0).all(dim=-1)
    return 2.0 * torch.log(torch.where(d > 0, d, 1.0)).sum(dim=-1), ok


def _t(M):
    return M.transpose(-1, -2)


def _finite(M):
    """(M with every matrix that holds a non-finite entry zeroed, the
    (..., ) mask of the finite ones).  The library routines raise on a
    non-finite input where the reference's return NaN; callers put NaN
    back where the mask is false."""
    ok = torch.isfinite(M).flatten(-2).all(dim=-1)
    return torch.where(ok[..., None, None], M, 0.0), ok


def _eigvalsh(M):
    """Eigenvalues (..., r), NaN for a matrix with a non-finite entry."""
    M, ok = _finite(M)
    return torch.where(ok[..., None], torch.linalg.eigvalsh(M), torch.nan)


def _scaled_products(state, g: Group, dz, ds):
    """(W dz, W^{-T} ds) = (R' Dz R, Rinv Ds Rinv') of the group's cones,
    (B, k, r, r) each."""
    R = state[f"psd{g.r}_R"]
    Rinv = state[f"psd{g.r}_Rinv"]
    Dz = svec_to_mat(_gather(dz, g), g)
    Ds = svec_to_mat(_gather(ds, g), g)
    return _t(R) @ Dz @ R, Rinv @ Ds @ _t(Rinv)


# ---------------------------------------------------------------------------
# composite-dispatch entry points (called from ops.py with its plan `p`)
# ---------------------------------------------------------------------------


def unit_init(p, z, s):
    """Identity matrices: 1 at the svec diagonal positions
    (unit_initialization!, coneops_psdtrianglecone.jl:46-61)."""
    for g in p.psd_groups:
        z = z.index_fill(1, g.diag_flat, 1.0)
        s = s.index_fill(1, g.diag_flat, 1.0)
    return z, s


def margins(p, z):
    """(min eigenvalue, sum of positive eigenvalues) over the problem's
    PSD cones, each (B,) (margins, coneops_psdtrianglecone.jl:8-27)."""
    alpha = torch.full_like(z[:, 0], FMAX)
    beta = torch.zeros_like(z[:, 0])
    for g in p.psd_groups:
        e = _eigvalsh(svec_to_mat(_gather(z, g), g))
        alpha = torch.minimum(alpha, e.amin(dim=(1, 2)))
        beta = beta + torch.clamp(e, min=0.0).sum(dim=(1, 2))
    return alpha, beta


def scaled_unit_shift(p, z, a):
    """z += a * svec(I) per cone, a (B, 1) (scaled_unit_shift!,
    coneops_psdtrianglecone.jl:30-43)."""
    for g in p.psd_groups:
        z = z.index_add(1, g.diag_flat, a.expand(-1, g.k * g.r))
    return z


def identity_scaling(p, batch):
    state = {}
    for g in p.psd_groups:
        eye = torch.eye(g.r, dtype=torch.float64, device=g.idx.device)
        eye = eye.expand(batch, g.k, g.r, g.r).contiguous()
        state[f"psd{g.r}_R"] = eye
        state[f"psd{g.r}_Rinv"] = eye.clone()
        state[f"psd{g.r}_lam"] = eye.new_ones(batch, g.k, g.r)
    return state


def update_scaling(p, s, z):
    """NT scaling via two Choleskys and an SVD per cone (update_scaling!,
    coneops_psdtrianglecone.jl:78-143).  -> (state, ok (B,))."""
    state = {}
    ok = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    for g in p.psd_groups:
        L1, ok1 = _cholesky(svec_to_mat(_gather(s, g), g))
        L2, ok2 = _cholesky(svec_to_mat(_gather(z, g), g))
        # a zeroed product (a failed factor) gives lam = 0, so okg false
        U, lam, Vh = torch.linalg.svd(_finite(_t(L2) @ L1)[0])
        lam_isqrt = 1.0 / torch.sqrt(torch.where(lam > 0, lam, 1.0))
        okg = ok1 & ok2 & (lam > 0).all(dim=-1)
        state[f"psd{g.r}_R"] = (L1 @ _t(Vh)) * lam_isqrt[..., None, :]
        state[f"psd{g.r}_Rinv"] = (lam_isqrt[..., :, None] * _t(U)) @ _t(L2)
        state[f"psd{g.r}_lam"] = lam
        ok = ok & okg.all(dim=1)
    return state, ok


def _skron(X, g: Group):
    """Symmetric Kronecker product blocks of X (..., r, r): (..., sd, sd)
    with H[(ij),(kl)] = c_ij c_kl (X_ik X_jl + X_il X_jk) / 2
    (skron!, coneops_psdtrianglecone.jl:502-540)."""
    i, j = g.rows, g.cols
    Xik = X[..., i[:, None], i[None, :]]
    Xjl = X[..., j[:, None], j[None, :]]
    Xil = X[..., i[:, None], j[None, :]]
    Xjk = X[..., j[:, None], i[None, :]]
    cc = g.cvec[:, None] * g.cvec[None, :]
    return cc * (Xik * Xjl + Xil * Xjk) * 0.5


def add_Hs_dense(p, state, Hmat):
    """Hs = skron(R R') into the dense (B, m, m) blocks."""
    B, m, _ = Hmat.shape
    H = Hmat.reshape(B, m * m)
    for g in p.psd_groups:
        R = state[f"psd{g.r}_R"]
        H = H.index_add(1, g.hs_flat, _skron(R @ _t(R), g).reshape(B, -1))
    return H.reshape(B, m, m)


def mul_Hs(p, state, x, y):
    """y = W'W x = svec((RR') X (RR')) (mul_Hs! via two W products,
    coneops_psdtrianglecone.jl:163-186)."""
    for g in p.psd_groups:
        R = state[f"psd{g.r}_R"]
        RRt = R @ _t(R)
        X = svec_to_mat(_gather(x, g), g)
        y = _scatter(y, g, mat_to_svec(RRt @ X @ RRt, g))
    return y


def affine_ds(p, state, ds):
    """ds = svec(Lambda^2) (affine_ds!, coneops_psdtrianglecone.jl:189-206);
    the off-diagonal entries keep ds's value (0)."""
    for g in p.psd_groups:
        lam = state[f"psd{g.r}_lam"]
        ds = ds.index_copy(1, g.diag_flat, (lam * lam).reshape(ds.shape[0],
                                                               -1))
    return ds


def combined_ds_shift(p, state, step_z, step_s, sigma_mu, shift):
    """shift = (W^{-T}ds) o (W dz) - sigma*mu*e with X o Y = (XY + YX)/2
    (_combined_ds_shift_symmetric!, coneops_symmetric_common.jl:2-35).
    sigma_mu (B,)."""
    for g in p.psd_groups:
        Wz, Ws = _scaled_products(state, g, step_z, step_s)
        vals = mat_to_svec((Ws @ Wz + Wz @ Ws) * 0.5, g)
        vals[..., g.diagpos] -= sigma_mu[:, None, None]
        shift = _scatter(shift, g, vals)
    return shift


def centrality_correction(p, state, z_t, s_t, lo, hi, corr):
    """Gondzio-corrector outlier term of the PSD blocks: the scaled trial
    complementarity M = (W^{-T}S_t) o (W Z_t) is eigendecomposed and its
    eigenvalues outside [lo, hi] (per problem, (B, 1)) are clipped; the
    returned svec term is M - clip(M) (the reference's own, no Clarabel
    counterpart)."""
    lo, hi = lo[:, :, None], hi[:, :, None]
    for g in p.psd_groups:
        Wz, Ws = _scaled_products(state, g, z_t, s_t)
        M, fin = _finite((Ws @ Wz + Wz @ Ws) * 0.5)
        lam, Q = torch.linalg.eigh(M)
        lam = torch.where(fin[..., None], lam, torch.nan)
        dlam = lam - torch.minimum(torch.maximum(lam, lo), hi)
        C = (Q * dlam[..., None, :]) @ _t(Q)
        corr = _scatter(corr, g, mat_to_svec(C, g))
    return corr


def ds_from_dz_offset(p, state, ds, out):
    """out = W'(lambda \\ ds): the lambda-inverse circ is elementwise
    2 Z_ij / (lam_i + lam_j), then W'(.) = R (.) R'
    (_Δs_from_Δz_offset_symmetric! + λ_inv_circ_op!,
    coneops_psdtrianglecone.jl:305-325)."""
    for g in p.psd_groups:
        R = state[f"psd{g.r}_R"]
        lam = state[f"psd{g.r}_lam"]
        Z = svec_to_mat(_gather(ds, g), g)
        denom = lam[..., :, None] + lam[..., None, :]
        X = 2.0 * Z / torch.where(denom != 0, denom, 1.0)
        out = _scatter(out, g, mat_to_svec(R @ X @ _t(R), g))
    return out


def step_length(p, state, dz, ds, alpha):
    """alpha (B,) capped by each problem's PSD boundary steps: with
    d = Lam^{-1/2} (W dx) Lam^{-1/2}, the step 1 / max(-eigmin(d))
    (step_length + step_length_psd_component,
    coneops_psdtrianglecone.jl:210-231,439-466)."""
    for g in p.psd_groups:
        lam = state[f"psd{g.r}_lam"]
        lam_isqrt = 1.0 / torch.sqrt(torch.where(lam > 0, lam, 1.0))
        for M in _scaled_products(state, g, dz, ds):
            scaled = lam_isqrt[..., :, None] * M * lam_isqrt[..., None, :]
            gamma = _eigvalsh(scaled).amin(dim=-1)
            lim = torch.where(gamma < 0,
                              1.0 / torch.clamp(-gamma, min=1e-300), FMAX)
            alpha = torch.minimum(alpha, lim.amin(dim=1))
    return alpha


def compute_barrier(p, z, s, dz, ds, alpha):
    """-logdet(Z + a dZ) - logdet(S + a dS) summed over the problem's
    cones, +BIG per cone that leaves the cone (compute_barrier +
    _logdet_barrier, coneops_psdtrianglecone.jl:234-269).  alpha (B,)."""
    a = alpha[:, None]
    zi, si = z + a * dz, s + a * ds
    barrier = torch.zeros_like(alpha)
    for g in p.psd_groups:
        ldz, okz = _chol_logdet(svec_to_mat(_gather(zi, g), g))
        lds, oks = _chol_logdet(svec_to_mat(_gather(si, g), g))
        terms = torch.where(okz & oks, -(ldz + lds), BIG)
        barrier = barrier + terms.sum(dim=1)
    return barrier
