"""Sparse host KKT backend: the native C++ LDL^T behind the dense
backend's (factorize, solve) interface.

The counterpart of `cuclarabel_tpu/kkt/sparse_cpu.py` and of the
reference's QDLDL direct-LDL backend
(`src/kktsolvers/direct-ldl/directldl_qdldl.jl` + the registry of
`directldl_defaults.jl`): symbolic analysis once on the first call,
in-place numeric refactorization each IPM iteration, signed dynamic
regularization inside the factorization, triangular solves, and
iterative refinement against the unregularized operator, all on the
host.  Selected with direct_solve_method="qdldl".

The JAX package reaches the host through ordered `io_callback`s from
inside its jitted loop.  Here the loop is eager, so the calls are
direct: the values are copied to the host, factored or solved there
with `native.LDLFactor`, and x is copied back to the loop's device.
The loop itself runs where the solver runs (CUDA by default).  Each
problem of a batch has its own factor, in a host loop over the batch.
"""

import numpy as np
import torch

from ..device import resolve_device


class _HostKKT:
    """Host-side factor state of one problem."""

    def __init__(self, n, m, settings, layout):
        self.n = n
        self.m = m
        self.N = n + m
        self.settings = settings
        self.layout = layout
        self.fac = None
        self.mask = None     # the stored (upper) pattern, dense bool
        self.pattern = None  # (rows, cols) upper-tri coordinate lists
        self.K = None  # scipy CSR of the current unregularized K

    def _build_pattern(self, K):
        mask = K != 0.0
        np.fill_diagonal(mask, True)  # structural diagonal
        # the Hs block's pattern is STRUCTURAL, not the first iterate's
        # values: identity scaling makes SOC/PSD blocks spuriously
        # diagonal on the first call.  Non-elementwise cones carry dense
        # blocks (get_Hs! semantics; same ranges the equilibration
        # rectifies, coneops_defaults.jl:32-44).
        for lo, hi in self.layout.rectification_ranges():
            mask[self.n + lo: self.n + hi, self.n + lo: self.n + hi] = True
        mask = np.triu(mask)
        iu, ju = np.nonzero(mask)
        order = np.lexsort((iu, ju))  # CSC order: by column, then row
        iu, ju = iu[order], ju[order]
        Ap = np.zeros(self.N + 1, dtype=np.int64)
        np.add.at(Ap, ju + 1, 1)
        Ap = np.cumsum(Ap)
        return mask, Ap, iu.astype(np.int64), (iu, ju)

    def factorize(self, P, A, Hs) -> bool:
        import scipy.sparse as sp

        from ..native import LDLFactor

        st = self.settings
        K = np.block([[P, A.T], [A, -Hs]])
        diag = np.abs(np.diagonal(K))
        eps = (
            st.static_regularization_constant
            + st.static_regularization_proportional
            * (diag.max() if len(diag) else 0.0)
        )
        dsigns = np.concatenate([np.ones(self.n), -np.ones(self.m)])
        Kreg = K + np.diag(dsigns * (eps if st.static_regularization_enable
                                     else 0.0))

        # a batch slot may be handed another problem (staged compaction
        # narrows the batch), whose pattern the stored one must cover
        if self.fac is None or np.any(np.triu(Kreg != 0.0) & ~self.mask):
            self.mask, Ap, Ai, self.pattern = self._build_pattern(Kreg)
            self.fac = LDLFactor(
                self.N, Ap, Ai, dsigns.astype(np.int64),
                reg_enable=st.dynamic_regularization_enable,
                eps=st.dynamic_regularization_eps,
                delta=st.dynamic_regularization_delta,
                # the reference forwards max_threads to its
                # multithreaded LDL backends (settings.jl:108-110); here
                # it sizes the level-parallel native refactorization
                # (0 = auto)
                max_threads=st.max_threads,
            )
        iu, ju = self.pattern
        ok = self.fac.refactor(Kreg[iu, ju])
        self.K = sp.csr_matrix(K)
        return ok

    def solve(self, b, ok: bool) -> np.ndarray:
        st = self.settings
        if self.fac is None or not ok:
            return np.full(self.N, np.nan)
        x = self.fac.solve(b)
        if st.iterative_refinement_enable:
            tol = (
                st.iterative_refinement_abstol
                + st.iterative_refinement_reltol * np.abs(b).max()
            )
            e = b - self.K @ x
            norme = np.abs(e).max()
            for _ in range(st.iterative_refinement_max_iter):
                if not np.isfinite(norme) or norme <= tol:
                    break
                dx = self.fac.solve(e)
                xn = x + dx
                en = b - self.K @ xn
                normen = np.abs(en).max()
                if normen >= norme:
                    break
                x, e, norme = xn, en, normen
        return x


def make_sparse_cpu_kkt(n: int, m: int, settings, layout, device=None):
    """(factorize, solve) with the dense backend's batched interface,
    the factorization and the solves running on the host with the
    native sparse LDL^T, one factor per problem of the batch:

    factorize(P (B, n, n), A (B, m, n), Hs (B, m, m)) -> (fac, ok (B,))
    solve(fac, rx (B, n), rz (B, m)) -> (x, z, ok (B,), nir (B,))

    The refinement runs inside the host solve, so nir is 0, as in the
    reference.  x comes back on the device of rx."""
    resolve_device(device)  # the loop's device: CUDA unless told "cpu"
    hosts = []

    def factorize(P, A, Hs):
        B = A.shape[0]
        while len(hosts) < B:
            hosts.append(_HostKKT(n, m, settings, layout))
        Ph, Ah, Hh = (t.detach().cpu().numpy() for t in (P, A, Hs))
        ok = [hosts[i].factorize(Ph[i], Ah[i], Hh[i]) for i in range(B)]
        ok_t = torch.tensor(ok, dtype=torch.bool, device=A.device)
        return {"ok": ok}, ok_t

    def solve(fac, rx, rz):
        b = torch.cat([rx, rz], dim=1).detach().cpu().numpy()
        x = np.stack([hosts[i].solve(b[i], fac["ok"][i])
                      for i in range(b.shape[0])])
        x = torch.as_tensor(x, dtype=torch.float64, device=rx.device)
        ok = torch.isfinite(x).all(dim=1)
        nir = torch.zeros(x.shape[0], dtype=torch.int32, device=rx.device)
        return x[:, :n], x[:, n:], ok, nir

    return factorize, solve
