"""Cone arithmetic of the plain reference, in NumPy, for one problem.

A cone list is [(kind, dim), ...] with kinds "zero", "nonneg", "soc"
and "psd" (dim the matrix side; svec storage as in
`portbench.generators`).  Vectors are laid out cone after cone.  The
functions here take the cones without the zero cone, whose rows the
solver treats as equality constraints.
"""

import numpy as np

from ..generators import smat, svec


def size(kind, dim):
    return dim * (dim + 1) // 2 if kind == "psd" else dim


def slices(cones):
    """(kind, dim, slice) for each cone, in order."""
    out, at = [], 0
    for kind, dim in cones:
        k = size(kind, dim)
        out.append((kind, dim, slice(at, at + k)))
        at += k
    return out


def degree(cones):
    return sum(dim if kind in ("nonneg", "psd") else 1
               for kind, dim in cones if kind != "zero")


def unit(cones, dtype):
    parts = []
    for kind, dim in cones:
        if kind == "nonneg":
            parts.append(np.ones(dim, dtype))
        elif kind == "soc":
            e = np.zeros(dim, dtype)
            e[0] = 1
            parts.append(e)
        elif kind == "psd":
            parts.append(svec(np.eye(dim, dtype=dtype)))
        else:
            raise ValueError(kind)
    return np.concatenate(parts)


def min_eig(cones, v):
    """The smallest 'eigenvalue' of v in each cone's Jordan algebra,
    least over the cones: v is in the interior iff it is > 0."""
    out = np.inf
    for kind, dim, sl in slices(cones):
        u = v[sl]
        if kind == "nonneg":
            e = u.min()
        elif kind == "soc":
            e = u[0] - np.linalg.norm(u[1:])
        else:
            e = np.linalg.eigvalsh(smat(u, dim))[0]
        out = min(out, e)
    return out


def circ(cones, u, v):
    """The Jordan product u o v."""
    out = np.empty_like(u)
    for kind, dim, sl in slices(cones):
        a, b = u[sl], v[sl]
        if kind == "nonneg":
            out[sl] = a * b
        elif kind == "soc":
            out[sl] = np.concatenate([[a @ b], a[0] * b[1:] + b[0] * a[1:]])
        else:
            A, B = smat(a, dim), smat(b, dim)
            out[sl] = svec((A @ B + B @ A) / 2)
    return out


def inv_circ(cones, lam, v):
    """x with lam o x = v; a PSD block of lam must be diagonal (the
    scaled point of `nt_scaling`)."""
    out = np.empty_like(v)
    for kind, dim, sl in slices(cones):
        l, b = lam[sl], v[sl]
        if kind == "nonneg":
            out[sl] = b / l
        elif kind == "soc":
            det = l[0] ** 2 - l[1:] @ l[1:]
            x0 = (l[0] * b[0] - l[1:] @ b[1:]) / det
            out[sl] = np.concatenate([[x0], (b[1:] - x0 * l[1:]) / l[0]])
        else:
            d = np.diag(smat(l, dim))
            out[sl] = svec(smat(b, dim) * 2 / (d[:, None] + d[None, :]))
    return out


def _psd_basis(dim, dtype):
    k = size("psd", dim)
    return smat(np.eye(k, dtype=dtype), dim)  # (k, dim, dim)


def nt_scaling(cones, s, z):
    """The Nesterov-Todd scaling of interior s, z: (W, lam) with W a
    block-diagonal matrix and lam = W z = W^-T s."""
    m = s.shape[0]
    W = np.zeros((m, m), s.dtype)
    lam = np.empty_like(s)
    for kind, dim, sl in slices(cones):
        a, b = s[sl], z[sl]
        if kind == "nonneg":
            w = np.sqrt(a / b)
            W[sl, sl] = np.diag(w)
            lam[sl] = np.sqrt(a * b)
        elif kind == "soc":
            J = -np.eye(dim, dtype=s.dtype)
            J[0, 0] = 1
            sn = np.sqrt(a[0] ** 2 - a[1:] @ a[1:])
            zn = np.sqrt(b[0] ** 2 - b[1:] @ b[1:])
            sb, zb = a / sn, b / zn
            gamma = np.sqrt((1 + sb @ zb) / 2)
            wb = (sb + J @ zb) / (2 * gamma)
            v = wb.copy()
            v[0] += 1
            v = v / np.sqrt(2 * v[0])
            Wk = np.sqrt(sn / zn) * (2 * np.outer(v, v) - J)
            W[sl, sl] = Wk
            lam[sl] = Wk @ b
        else:
            Ls = np.linalg.cholesky(smat(a, dim))
            Lz = np.linalg.cholesky(smat(b, dim))
            U, sig, Vt = np.linalg.svd(Lz.T @ Ls)
            r = Ls @ Vt.T / np.sqrt(sig)[None, :]
            # W(Z) = r' Z r, as a matrix on svec coordinates
            basis = _psd_basis(dim, s.dtype)
            W[sl, sl] = svec(np.einsum("ji,kjl,lm->kim", r, basis, r)).T
            lam[sl] = svec(np.diag(sig).astype(s.dtype))
    return W, lam


def step_to_boundary(cones, v, dv):
    """The largest alpha with v + alpha dv in the cone (inf if none
    bounds it), for interior v."""
    amax = np.inf
    for kind, dim, sl in slices(cones):
        a, d = v[sl], dv[sl]
        if kind == "nonneg":
            neg = d < 0
            if neg.any():
                amax = min(amax, np.min(-a[neg] / d[neg]))
        elif kind == "soc":
            # (a0 + t d0)^2 - |a1 + t d1|^2 = qa t^2 + qb t + qc, qc > 0
            qa = d[0] ** 2 - d[1:] @ d[1:]
            qb = 2 * (a[0] * d[0] - a[1:] @ d[1:])
            qc = a[0] ** 2 - a[1:] @ a[1:]
            disc = qb * qb - 4 * qa * qc
            if disc >= 0:
                # the roots, without cancellation: qc / r and r / qa
                r = -(qb + np.copysign(np.sqrt(disc), qb)) / 2
                roots = [qc / r if r != 0 else np.inf,
                         r / qa if qa != 0 else np.inf]
                pos = [t for t in roots if t > 0]
                if pos:
                    amax = min(amax, min(pos))
            if d[0] < 0:
                amax = min(amax, -a[0] / d[0])
        else:
            L = np.linalg.cholesky(smat(a, dim))
            Li = np.linalg.inv(L)
            M = Li @ smat(d, dim) @ Li.T
            e = np.linalg.eigvalsh((M + M.T) / 2)[0]
            if e < 0:
                amax = min(amax, -1.0 / e)
    return amax


def project(cones, v, dual=False):
    """The Euclidean projection onto the cone (with dual=True onto the
    dual cone: the zero cone's dual is the whole space); every cone
    here but the zero cone is self-dual."""
    out = np.array(v, copy=True)
    for kind, dim, sl in slices(cones):
        u = v[..., sl]
        if kind == "zero":
            out[..., sl] = u if dual else 0.0
        elif kind == "nonneg":
            out[..., sl] = np.maximum(u, 0.0)
        elif kind == "soc":
            t, w = u[..., 0], u[..., 1:]
            nw = np.linalg.norm(w, axis=-1)
            inside = nw <= t
            below = nw <= -t
            c = np.where(inside | below, 0.0, (t + nw) / 2)
            scale = np.divide(c, nw, out=np.zeros_like(c), where=nw > 0)
            proj = np.concatenate([c[..., None], w * scale[..., None]],
                                  axis=-1)
            proj = np.where(inside[..., None], u, proj)
            proj = np.where(below[..., None], 0.0, proj)
            out[..., sl] = proj
        else:
            ev, Q = np.linalg.eigh(smat(u, dim))
            M = (Q * np.maximum(ev, 0.0)[..., None, :]) @ np.swapaxes(
                Q, -1, -2)
            out[..., sl] = svec(M)
    return out
