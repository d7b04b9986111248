"""Dense quasidefinite KKT backend, batched over problems.

The counterpart of `cuclarabel_tpu/kkt/dense.py`.  The reduced KKT
system (after eliminating Delta_s and the tau column,
`src/kktsystem.jl:5-232`)

    K = [ P   A' ]
        [ A  -Hs ]

is symmetric quasidefinite once statically regularised with signed
epsilon (+eps on the x block, -eps on the z block).  Every function here
takes a leading batch dimension: P (B, n, n), A (B, m, n), Hs (B, m, m),
right-hand sides (B, n) and (B, m).  Flags (`ok`) and refinement counts
(`nir`) are per problem, (B,).

Methods (`resolve_kkt_method`):
  * "pallas": the hand-written LDL^T kernels of `kkt/ldl.py` on the
    scaled, permuted K, at any N (the narrow forms at N <= 128, the wide
    ones above, as the reference's factor takes any N).  The name stays
    for parity with the reference `Settings`; the kernels are CUDA, not
    Pallas.  On layouts
    with nonsymmetric cones its refinement holds x to the regularised
    K + diag(reg), the matrix the kernel factors, so that it corrects
    the factor's rounding and leaves the static regularisation in
    place.  This departs from the reference, which refines against the
    unregularised K in double-float arithmetic: in f64 that refinement
    carries the step on to the unregularised system's, and on
    `problems.exp_logistic` batches (seed 1000) 13 of 300 problems then
    end ALMOST_SOLVED, against none of 300 in the reference's "pallas"
    batch and none here with the regularised K (ROADMAP F8).
  * "lu", "qr", "inverse": a library factorisation of the regularised,
    row-scaled K at the factor precision (f64, or f32 under
    kkt_factor_precision="float32"; reference dense.py:507-577), then
    iterative refinement in f64 against the unregularised K:
      - "lu": pivoted LU (`torch.linalg.lu_factor`);
      - "qr": Householder QR (`torch.linalg.qr`) and a triangular solve;
      - "inverse": `torch.linalg.inv_ex` and one Newton-Schulz step,
        Kinv (2I - K Kinv), so that every solve is one batched product.
        The reference inverts an f64 K without pivoting (its
        `pivotfree_inv`, on the stability-ordered K) because XLA on a TPU
        has no f64 LU; CUDA has one, so both precisions take the pivoted
        inverse of the unpermuted K, as the reference's f32 does.
    "pallas" ignores the factor precision, as the reference's does.
"""

import numpy as np
import torch

from ..device import resolve_device
from .ldl import (NARROW_MAX_N, kkt_residual, ldl_factor, ldl_solve,
                  ldl_solve_refine)


def _gj_inv_small(M):
    """No-pivot Gauss-Jordan inverse of a small (..., N, N) block
    (reference dense.py:39-52): every diagonal block that the recursive
    Schur split of a regularised quasidefinite matrix reaches is itself
    quasidefinite, so its pivots are nonzero."""
    N = M.shape[-1]
    eye = torch.eye(N, dtype=M.dtype, device=M.device).expand(M.shape)
    X = torch.cat([M, eye], dim=-1)
    for i in range(N):
        piv = X[..., i, :] / X[..., i, i:i + 1]
        X = X - X[..., :, i:i + 1] * piv[..., None, :]
        X[..., i, :] = piv
    return X[..., N:]


def pivotfree_inv(M):
    """Pivot-free inverse of a regularised quasidefinite (..., N, N)
    matrix by recursive 2x2 block Schur complements (reference
    dense.py:55-83), split at N // 2, Gauss-Jordan at N <= 8:

        inv([A B; C D]) = [Ai + AiB Si CAi,  -AiB Si]
                          [      -Si CAi,        Si ]

    with Ai = inv(A), S = D - C Ai B and Si = inv(S).  Leading principal
    blocks of a quasidefinite matrix are quasidefinite, so no block needs
    a pivot (Vanderbei 1995).  The block-arrow KKT (`kkt/arrow.py`)
    inverts its saddle with it, as the reference does."""
    N = M.shape[-1]
    if N <= 8:
        return _gj_inv_small(M)
    k = N // 2
    A = M[..., :k, :k]
    B = M[..., :k, k:]
    C = M[..., k:, :k]
    D = M[..., k:, k:]
    Ai = pivotfree_inv(A)
    AiB = Ai @ B
    Si = pivotfree_inv(D - C @ AiB)
    SiCAi = Si @ (C @ Ai)
    top = torch.cat([Ai + AiB @ SiCAi, -(AiB @ Si)], dim=-1)
    bot = torch.cat([-SiCAi, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def resolve_kkt_method(settings, N: int) -> str:
    """Resolve kkt_solve_method='auto': "pallas" (the LDL^T kernels) for
    N <= 128 and "lu" above.  This differs from the reference, which
    picks "qr" or "inverse" above its Pallas cap because XLA on a TPU has
    no f64 LU; CUDA has one.  An explicit "pallas" runs the kernels at
    any N, as the reference's does (their wide forms above 128)."""
    method = settings.kkt_solve_method
    if method == "auto":
        method = "pallas" if N <= NARROW_MAX_N else "lu"
    return method


def refines_regularised(layout) -> bool:
    """Whether the "pallas" path refines against the regularised K (the
    module docstring says why): on layouts with nonsymmetric cones."""
    return layout is not None and layout.has_nonsymmetric


def resolve_dd_npass(settings) -> int:
    """Refinement passes fused into the refined-solve kernel launch (the
    reference's default: 1 while refinement is on, 0 when off).  The
    outer tolerance loop picks up the rare further passes."""
    if not settings.iterative_refinement_enable:
        return 0
    return max(0, min(1, settings.iterative_refinement_max_iter))


def make_dense_kkt(n: int, m: int, settings, layout=None, device=None):
    """Returns (factorize, solve):

    factorize(P, A, Hs) -> (fac, ok)
    solve(fac, rx, rz) -> (x, z, ok, nir)

    With method "pallas", `solve.pair(fac, rx1, rz1, rx2, rz2)` solves
    two systems against one factor in 2-RHS kernel launches and returns
    (x1, z1, x2, z2, ok, nir).  Runs on `device` (device.resolve_device:
    CUDA unless the caller passes device="cpu")."""
    device = resolve_device(device)
    N = n + m
    eps_const = settings.static_regularization_constant
    eps_prop = settings.static_regularization_proportional
    reg_enable = settings.static_regularization_enable
    ir_enable = settings.iterative_refinement_enable
    ir_reltol = settings.iterative_refinement_reltol
    ir_abstol = settings.iterative_refinement_abstol
    ir_maxiter = settings.iterative_refinement_max_iter
    stop_ratio = min(settings.iterative_refinement_stop_ratio, 1.2)

    f64 = torch.float64
    dsigns = torch.cat([torch.ones(n, dtype=f64), -torch.ones(m, dtype=f64)]
                       ).to(device)

    # Stability ordering for pivot-free elimination (reference
    # dense.py:207-222): inequality slack rows first, then the x block,
    # then equality (zero-cone) rows last.
    zero_mask = (
        np.asarray(layout.zero_mask)
        if layout is not None and getattr(layout, "has_zero", False)
        else np.zeros(m, dtype=bool)
    )
    mrows = np.arange(m) + n
    perm_np = np.concatenate([mrows[~zero_mask], np.arange(n),
                              mrows[zero_mask]])
    perm = torch.as_tensor(perm_np, device=device)
    iperm = torch.as_tensor(np.argsort(perm_np), device=device)

    method = resolve_kkt_method(settings, N)
    refine_regularised = refines_regularised(layout)

    def _assemble_K(P, A, Hs):
        top = torch.cat([P, A.transpose(1, 2)], dim=2)
        bot = torch.cat([A, -Hs], dim=2)
        return torch.cat([top, bot], dim=1)  # unregularised

    def _eps(K):
        if not reg_enable:
            return torch.zeros(K.shape[0], dtype=f64, device=K.device)
        # eps = const + proportional * max |diag K|
        # (kktsolver_directldl.jl:297-310)
        return eps_const + eps_prop * torch.diagonal(K, 0, 1, 2).abs().amax(
            dim=1)

    def _tol(b):
        return ir_abstol + ir_reltol * b.abs().amax(dim=1)  # (B, R)

    def _refine(step, x, e, norme, tol, nir):
        """The outer refinement loop over (B, N, R) iterates.  While a
        right-hand side is above `tol` and its problem has passes left,
        try step(x, e) -> (x + solve(e), its residual, its norm (B, R));
        accept per (rhs, problem) where the norm falls (ratio > 1), and
        go on only while it falls by more than min(stop_ratio, 1.2).
        `nir` counts the passes per problem.  -> (x, ok (B,), nir)."""
        ok = torch.isfinite(norme)
        stop = torch.zeros_like(ok)
        while True:
            live = ~stop & ok & (norme > tol)
            run = (nir < ir_maxiter) & live.any(dim=1)  # (B,)
            if not bool(run.any()):
                break
            live = live & run[:, None]
            xn, en, normen = step(x, e)
            ratio = norme / torch.where(normen > 0, normen, 1e-300)
            acc = live & (ratio > 1.0)
            x = torch.where(acc[:, None, :], xn, x)
            e = torch.where(acc[:, None, :], en, e)
            norme = torch.where(acc, normen, norme)
            nir = torch.where(run, nir + 1, nir)
            stop = torch.where(run[:, None],
                               stop | ~(live & (ratio > stop_ratio)), stop)
            ok = torch.where(live, torch.isfinite(normen), ok)
        return x, (ok & torch.isfinite(norme)).all(dim=1), nir

    if method == "pallas":
        npass = resolve_dd_npass(settings)

        def _assemble(P, A, Hs):
            """The reference's `_assemble_dd` (dense.py:378-427) in f64:
            eps from max |diag K|; one-shot symmetric row scaling with
            rn = max(rowmax |K|, eps), dj = 1/sqrt(rn); the signed
            regularisation `regdiag`, in the scaled space, is added inside
            the factor so the stored K stays unregularised.  The reference
            takes the row maxima from an f32 cast for TPU speed; here they
            are f64, which moves dj by about 1e-7 relative."""
            K = _assemble_K(P, A, Hs)
            eps = _eps(K)
            rn = torch.maximum(K.abs().amax(dim=2), eps[:, None])
            dj = 1.0 / torch.sqrt(torch.where(rn > 1e-30, rn, 1.0))
            Ks = K * (dj[:, :, None] * dj[:, None, :])
            regdiag = dsigns * eps[:, None] * dj * dj
            return Ks, dj, regdiag

        def factorize(P, A, Hs):
            Ks, dj, regdiag = _assemble(P, A, Hs)
            Ksp = Ks[:, perm][:, :, perm].contiguous()
            regp = regdiag[:, perm].contiguous()
            L, Dinv, ok = ldl_factor(Ksp, regp)
            if refine_regularised:  # the refinement's operator (above)
                Ksp = Ksp + torch.diag_embed(regp)
            return {"K": Ksp, "L": L, "Dinv": Dinv, "dj": dj}, ok

        def _solve_rhs(fac, b):
            """Refined solve of b (B, N, R) in the scaled, permuted domain
            (reference dense.py:440-505 and :629-716; residuals against
            the unregularised operator, kktsolver_directldl.jl:389-449):
            the fused kernel does the solve and `npass` gated passes in
            one launch, and `_refine` runs only for the stragglers still
            above tolerance.  Returns (x (B, N, R), ok (B,), nir (B,))."""
            dj = fac["dj"]
            djp = dj[:, perm, None]
            bs = (dj[:, :, None] * b)[:, perm].contiguous()
            if not ir_enable:
                x = ldl_solve(fac["L"], fac["Dinv"], bs)
                nir = torch.zeros(b.shape[0], dtype=torch.int32,
                                  device=b.device)
                ok = torch.isfinite(x).flatten(1).all(dim=1)
                return dj[:, :, None] * x[:, iperm], ok, nir

            def norm(rs):
                # rs = dj*(b - K x)[perm]: undo the row scaling for the
                # tolerance test in the reference's (unscaled) units
                return (rs / djp).abs().amax(dim=1)

            def step(x, e):
                xn = x + ldl_solve(fac["L"], fac["Dinv"], e)
                en = kkt_residual(fac["K"], xn, bs)
                return xn, en, norm(en)

            x, e = ldl_solve_refine(fac["K"], fac["L"], fac["Dinv"], bs,
                                    npass)
            nir = torch.full((b.shape[0],), npass, dtype=torch.int32,
                             device=b.device)
            x, ok, nir = _refine(step, x, e, norm(e), _tol(b), nir)
            return dj[:, :, None] * x[:, iperm], ok, nir

        def solve(fac, rx, rz):
            x, ok, nir = _solve_rhs(fac, torch.cat([rx, rz], dim=1)[:, :, None])
            return x[:, :n, 0], x[:, n:, 0], ok, nir

        def solve_pair(fac, rx1, rz1, rx2, rz2):
            """Two refined solves against one factor in 2-RHS launches
            (reference dense.py:629-716), acceptance per (rhs, problem)."""
            b = torch.stack([torch.cat([rx1, rz1], dim=1),
                             torch.cat([rx2, rz2], dim=1)], dim=2)
            x, ok, nir = _solve_rhs(fac, b)
            return (x[:, :n, 0], x[:, n:, 0], x[:, :n, 1], x[:, n:, 1],
                    ok, nir)

        solve.pair = solve_pair
        return factorize, solve

    # ------------------------------------------------ lu, qr and inverse
    factor_dtype = (torch.float32 if settings.kkt_factor_precision == "float32"
                    else f64)

    if method == "lu":
        def factor(Ks):
            lu, piv, _ = torch.linalg.lu_factor_ex(Ks)
            return {"lu": lu, "piv": piv}, lu

        def raw(fac, r):
            return torch.linalg.lu_solve(fac["lu"], fac["piv"], r)
    elif method == "qr":
        def factor(Ks):
            Q, R = torch.linalg.qr(Ks)
            return {"Q": Q, "R": R}, R

        def raw(fac, r):
            return torch.linalg.solve_triangular(
                fac["R"], torch.bmm(fac["Q"].transpose(1, 2), r), upper=True)
    else:  # "inverse"
        eye2 = 2.0 * torch.eye(N, dtype=factor_dtype, device=device)

        def factor(Ks):
            # inv_ex: inv without its error check, which syncs the host;
            # a singular K leaves non-finite entries, which clear `ok`
            Kinv = torch.linalg.inv_ex(Ks)[0]
            Kinv = torch.bmm(Kinv, eye2 - torch.bmm(Ks, Kinv))
            return {"Kinv": Kinv}, Kinv

        def raw(fac, r):
            return torch.bmm(fac["Kinv"], r)

    def factorize(P, A, Hs):
        K = _assemble_K(P, A, Hs)
        eps = _eps(K)
        Kreg = K + torch.diag_embed(dsigns * eps[:, None])
        # symmetric row-norm (one-shot Ruiz) pre-scaling of the matrix
        # handed to the factorisation (reference dense.py:192-205)
        rn = Kreg.abs().amax(dim=2)
        dj = 1.0 / torch.sqrt(torch.where(rn > 1e-300, rn, 1.0))
        Ks = Kreg * (dj[:, :, None] * dj[:, None, :])
        fac, out = factor(Ks.to(factor_dtype))
        ok = torch.isfinite(out).flatten(1).all(dim=1)
        fac.update(K=K, dj=dj[:, :, None])
        return fac, ok

    def solve(fac, rx, rz):
        """-> (x, z, ok, nir); refinement against the unregularised K
        (reference dense.py:719-771)."""
        b = torch.cat([rx, rz], dim=1)[:, :, None]
        K, dj = fac["K"], fac["dj"]

        def raw_solve(r):
            return dj * raw(fac, (dj * r).to(factor_dtype)).to(f64)

        def step(x, e):
            xn = x + raw_solve(e)
            en = b - torch.bmm(K, xn)
            return xn, en, en.abs().amax(dim=1)

        x = raw_solve(b)
        if ir_enable:
            e = b - torch.bmm(K, x)
            nir = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
            x, ok, nir = _refine(step, x, e, e.abs().amax(dim=1), _tol(b), nir)
        else:
            ok = torch.isfinite(x).flatten(1).all(dim=1)
            nir = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
        return x[:, :n, 0], x[:, n:, 0], ok, nir

    return factorize, solve
