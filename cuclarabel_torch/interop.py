"""Carry the reference's state across to the port.

A solver has no weights; what the JAX package holds and the port must
take over unchanged is its settings, its cone specifications, the
problem data in the shape its batch front end gives it, and (for the
kernel and cone tests) its LDL^T factor and its per-problem cone
scaling state.  Everything here takes numpy (or objects with the
reference's attributes) and imports no JAX.
"""

import numpy as np
import torch

from .cones import api
from .cones.api import cones_collapsed
from .settings import Settings


def settings_from_reference(d: dict) -> Settings:
    """A port `Settings` from `dataclasses.asdict` of a reference one."""
    return Settings.from_dict(dict(d))


def batchify(M, batch: int, shape) -> np.ndarray:
    """(batch,) + shape f64 array from None (zeros), a dense or
    scipy.sparse matrix shared by the batch, or a per-problem stack."""
    M = np.zeros(shape) if M is None else np.asarray(
        M.toarray() if hasattr(M, "toarray") else M, dtype=np.float64)
    if M.ndim == 2:
        M = np.broadcast_to(M, (batch,) + M.shape)
    if M.shape != (batch,) + tuple(shape):
        raise ValueError(f"expected {(batch,) + tuple(shape)}, got {M.shape}")
    return M


def symmetrize_triu(P) -> np.ndarray:
    """The symmetric matrices whose upper triangles are P's (the
    reference reads the upper triangle, batch.py:380-382)."""
    return np.triu(P) + np.transpose(np.triu(P, 1), (0, 2, 1))


def problem_from_numpy(P, q, A, b, cones):
    """(P, q, A, b, cones) as the reference's BatchSolver takes them ->
    dict of f64 arrays P (B, n, n) symmetrised from its upper triangle,
    q (B, n), A (B, m, n), b (B, m), and the collapsed cone list."""
    q = np.asarray(q, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if q.ndim != 2 or b.ndim != 2 or q.shape[0] != b.shape[0]:
        raise ValueError("q must be (B,n) and b (B,m) with equal B")
    B, n = q.shape
    m = b.shape[1]
    return {
        "P": symmetrize_triu(batchify(P, B, (n, n))),
        "q": q,
        "A": np.ascontiguousarray(batchify(A, B, (m, n))),
        "b": b,
        "cones": cones_collapsed(list(cones)),
    }


def factor_from_reference(Lh, Ll, Dh, Dl):
    """The reference's lane-major (N, N, B) / (N, B) f32 (hi, lo) factor
    pairs (`pallas_dd.dd_ldl_factor`) -> the port's f64 L (B, N, N),
    strictly lower (the reference leaves junk on and above the
    diagonal), and Dinv (B, N), each through hi + lo."""
    join = lambda h, l: (np.asarray(h, dtype=np.float64)  # noqa: E731
                         + np.asarray(l, dtype=np.float64))
    L = np.tril(np.moveaxis(join(Lh, Ll), -1, 0), -1)
    Dinv = np.moveaxis(join(Dh, Dl), -1, 0)
    return np.ascontiguousarray(L), np.ascontiguousarray(Dinv)


def cones_from_reference(cones):
    """The port's cone specifications for the reference's, matched by
    class name and attributes (dim, alpha, dim2), so that no module of
    the JAX package is imported."""
    out = []
    for c in cones:
        name = type(c).__name__
        cls = getattr(api, name)
        if name == "ExponentialConeT":
            out.append(cls())
        elif name == "PowerConeT":
            out.append(cls(float(c.alpha)))
        elif name == "GenPowerConeT":
            out.append(cls(tuple(float(a) for a in c.alpha), int(c.dim2)))
        else:
            out.append(cls(int(c.dim)))
    return out


def scaling_state_from_reference(layout, states, device="cpu"):
    """The port's batched scaling state from the reference's per-problem
    states of the cones of `layout` (one dict per problem, e.g.
    `cones/ops.update_scaling`'s, as numpy arrays): each entry stacked
    over the problems into a (B, ...) f64 tensor, so that the two sides'
    cone operations can be applied to one and the same state.  The PSD
    cones' `psd{r}_R`, `psd{r}_Rinv` (k, r, r) and `psd{r}_lam` (k, r)
    become (B, k, r, r) and (B, k, r)."""
    counts = {"exp": layout.nexp, "pow": layout.npow, "gp": layout.ngp}
    counts.update({f"psd{r}": idx.shape[0]
                   for r, idx in layout.psd_groups.items()})
    out = {}
    for k in states[0]:
        v = np.stack([np.asarray(st[k], dtype=np.float64) for st in states])
        kind = k.split("_")[0]
        if kind in counts and k != "gp_mu" and v.shape[1] != counts[kind]:
            raise ValueError(f"{k}: {v.shape[1]} cones, the layout has "
                             f"{counts[kind]}")
        out[k] = torch.as_tensor(v, device=device)
    return out


def sparse_problem_from_reference(sp_prob):
    """The port's kkt.sparse_tpu.SparseProblem from the reference's (its
    COO index arrays, numpy), without the reference's memo."""
    from .kkt.sparse_tpu import SparseProblem

    return SparseProblem(
        n=int(sp_prob.n), m=int(sp_prob.m),
        **{k: np.asarray(getattr(sp_prob, k), dtype=np.int64)
           for k in ("P_rows", "P_cols", "A_rows", "A_cols")})


def plan_arrays_from_reference(plan) -> dict:
    """A reference NumericPlan's index maps (`device_arrays()`) as numpy
    arrays, the form of the port's `NumericPlan.device_arrays()`."""
    return {k: np.asarray(v) for k, v in plan.device_arrays().items()}
