"""Block-arrow Schur-complement KKT backend over row shards.

The counterpart of `cuclarabel_tpu/kkt/arrow.py`, which solves the
reduced KKT system

    [ P   A' ] [x]   [rx]
    [ A  -Hs ] [z] = [rz]

by eliminating every constraint row whose Hs is diagonal (nonnegative
rows, the diagonal part of expanded second-order cones and of
generalised power cones) and keeping the rest explicit: zero-cone rows
and the rows of small dense Hs blocks (SOC dim <= 4, exp/pow 3x3, PSD
svec blocks) as rows of a dense saddle, and the low-rank expansion
vectors of the big SOCs (u, v) and GenPow cones (q, r, p) as extra
unknowns t with the sparse assembly's signs.  What remains after the
elimination is the dense saddle

    M = [ S    B    A_ex' ]      S = P + eps I + A_el' D^-1 A_el
        [ B'   C     0    ]      B = A_el' D^-1 V
        [ A_ex 0   -Hex   ]      C = E + V' D^-1 V

a Schur complement of a quasidefinite matrix, which `pivotfree_inv`
inverts without pivoting, as the reference does, with one guard: that
recursive inverse loses accuracy about as cond(M)^2.  On the
box-and-budget QP of `problems.box_budget_qp` (n = 512, m = 65,537) the
saddle grows ill-conditioned as the solve converges (cond 2.6e9 to
4.4e12 in its last three factorizations), where max|M X - I| of the
pivot-free inverse reached 78 (pivoted LU's 7.4e-5), and with it alone
the solve ends ALMOST_SOLVED; the reference's ShardedSolver ends it
INSUFFICIENT_PROGRESS (`tests/torch_arrow_inverse.py 65536
--residuals --reference`, ROADMAP F12).  So where the pivot-free
inverse's residual exceeds 1e-2, `saddle_inverse` inverts M again with
pivoted LU and keeps the inverse with the smaller residual; that QP then
ends SOLVED, and the parity problems of tests/test_torch_arrow.py keep
the reference's iterations.  Refinement is the
reference's loop (arrow.py:339-388) against the unregularised augmented
operator, except on layouts with nonsymmetric cones, where it holds the
solution to the regularised saddle that was inverted, as the dense
"pallas" path does there (`dense.refines_regularised`, ROADMAP F8).
Against the unregularised operator the last iterations of an exp/pow
problem need many passes and end on a knife edge: the exp/pow problem of
tests/test_sharded_single.py on one shard ended ALMOST_SOLVED, off the
reference ShardedSolver's iterations (the parity test of
tests/test_torch_arrow.py failed that way), and keeps the reference's
status and iterations at 1, 2 and 8 shards with the regularised one.

Where the reference shards with `shard_map` over a device mesh, here the
shards are an ordered list of devices (`ShardedRows`):
  * what grows as m x n is split into row slabs, one per device: A, and
    the eliminated rows' D^-1 and V;
  * everything else stays on devices[0]: the m-vectors and the cone
    operations, the saddle M and its inverse;
  * every psum of the reference is the shards' partial products moved
    to devices[0] and summed there in shard order, so a repeat solve is
    bitwise equal;
  * a replicated operand that a shard needs (x, t, the slab of an
    m-vector) is copied to it.
With device="cpu" every shard is the CPU.  One problem (B = 1), as the
reference's ShardedSolver solves one; tensors keep the loop's leading
batch dimension of 1 at the interface.
"""

import collections

import numpy as np
import torch

from ..cones import ops as cone_ops
from .dense import pivotfree_inv, refines_regularised

F64 = torch.float64


def _inf_norm(v):
    if v.numel() == 0:
        return v.new_zeros(())
    return v.abs().amax()


class ShardedRows:
    """An (m, n) matrix in row slabs of m / len(devices) rows, slab i on
    devices[i]; the vectors it multiplies and returns live on
    devices[0] ("home")."""

    def __init__(self, slabs, devices):
        self.devices = list(devices)
        self.home = self.devices[0]
        self.slabs = slabs
        self.n = slabs[0].shape[1]
        self.m_loc = slabs[0].shape[0]
        self.m = self.m_loc * len(slabs)

    @classmethod
    def from_host(cls, A, devices):
        """From a host (m, n) array; m must divide into len(devices)."""
        A = np.asarray(A, dtype=np.float64)
        k = len(devices)
        m = A.shape[0]
        if m % k:
            raise ValueError(f"m={m} must divide the {k} shards")
        step = m // k
        return cls([torch.from_numpy(np.ascontiguousarray(
            A[i * step:(i + 1) * step])).to(dev)
            for i, dev in enumerate(devices)], devices)

    @classmethod
    def from_home(cls, M, like):
        """An (m, c) tensor on the home device, split like `like`."""
        return cls(like.split(M), like.devices)

    def split(self, v):
        """A home tensor with m leading rows -> its slabs, each on its
        shard's device."""
        s = self.m_loc
        return [v[i * s:(i + 1) * s].to(dev)
                for i, dev in enumerate(self.devices)]

    def gather(self, parts):
        """The shards' row pieces, concatenated on the home device."""
        return torch.cat([p.to(self.home) for p in parts])

    def reduce(self, parts):
        """The shards' partial sums, summed on the home device in shard
        order (never an order that can change between runs)."""
        acc = parts[0].to(self.home)
        for p in parts[1:]:
            acc = acc + p.to(self.home)
        return acc

    def rows(self, x):
        """M x for x (c,) on the home device -> (m,) on it."""
        return self.gather([torch.mv(a, x.to(a.device))
                            for a in self.slabs])

    def cols(self, w):
        """M' w for w (m,) on the home device -> (c,) on it."""
        return self.reduce([torch.mv(a.T, ws)
                            for a, ws in zip(self.slabs, self.split(w))])

    # the loop's batch-of-one products
    def mv(self, v):
        return self.rows(v[0])[None]

    def rmv(self, v):
        return self.cols(v[0])[None]


# the pivot-free inverse's residual max|M X - I| above which the saddle
# is inverted again with pivoted LU (module docstring)
INVERSE_RESIDUAL_MAX = 1e-2
# factorizations by the inverse they kept: "pivotfree" or "lu"
SADDLE_INVERSES = collections.Counter()


def saddle_inverse(M):
    """pivotfree_inv(M), the reference's inverse, unless its residual
    max|M X - I| exceeds INVERSE_RESIDUAL_MAX and pivoted LU's inverse
    (torch.linalg.inv_ex) has a smaller one; one host sync."""
    X = pivotfree_inv(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    err = (M @ X - eye).abs().amax()
    if not bool(err <= INVERSE_RESIDUAL_MAX):
        Y, info = torch.linalg.inv_ex(M)
        if bool((info == 0) & ((M @ Y - eye).abs().amax() < err)):
            SADDLE_INVERSES["lu"] += 1
            return Y
    SADDLE_INVERSES["pivotfree"] += 1
    return X


def make_arrow_kkt(n: int, m: int, settings, layout, devices,
                   refine_regularised=None):
    """(factorize, solve) over the shard devices, with the structured-Hs
    interface of the sparse backends (reference arrow.py:69-388):

    factorize(P (1, n, n), A ShardedRows, (diag, blk_vals, socx, gpx))
        -> (fac, ok (1,))
    solve(fac, rx (1, n), rz (1, m)) -> (x, z, ok (1,), nir (1,))

    The Hs tuple is cones/ops.py's sparse_hs_values at a batch of one;
    factorize carries `structured_hs = True` so that the loop assembles
    it in place of the dense (m, m) Hs.  refine_regularised: whether
    refinement holds the solution to the regularised saddle (None: on
    layouts with nonsymmetric cones; see the module docstring)."""
    devices = list(devices)
    ndev = len(devices)
    if m % ndev != 0:
        raise ValueError(f"m={m} must divide the {ndev} shards")
    home = devices[0]

    plan = cone_ops.sparse_hs_plan(layout)
    nx = len(plan["socx_rows"])      # expanded SOC count
    ngx = len(plan["gpx_cone"])      # GenPow count (always expanded)
    nw = 2 * nx + 3 * ngx            # explicit low-rank saddle unknowns

    eps_const = settings.static_regularization_constant
    eps_prop = settings.static_regularization_proportional
    reg_enable = settings.static_regularization_enable
    ir_enable = settings.iterative_refinement_enable
    ir_reltol = settings.iterative_refinement_reltol
    ir_abstol = settings.iterative_refinement_abstol
    ir_maxiter = settings.iterative_refinement_max_iter
    ir_stopratio = min(settings.iterative_refinement_stop_ratio, 1.2)
    if refine_regularised is None:
        refine_regularised = refines_regularised(layout)

    # ---- host row classification (reference arrow.py:105-158)
    ex_mask_np = np.asarray(layout.zero_mask, dtype=bool).copy()
    blk_rows = plan["blk_rows"]
    blk_cols = plan["blk_cols"]
    ex_mask_np[blk_rows] = True
    ex_mask_np[blk_cols] = True
    ex_idx_np = np.nonzero(ex_mask_np)[0]
    mex = int(ex_idx_np.shape[0])
    # position of each explicit row inside the saddle's z_ex block
    ex_pos_np = np.zeros(m, dtype=np.int64)
    ex_pos_np[ex_idx_np] = np.arange(mex)
    # the Hex entries: blk entries have row <= col within each cone
    hex_i_np = ex_pos_np[blk_rows]
    hex_j_np = ex_pos_np[blk_cols]
    hex_off_np = np.nonzero(blk_rows != blk_cols)[0]
    # V's entries: per SOC (v -> col 2t, u -> col 2t+1), per GenPow
    # (q, r, p -> cols 2nx+3t+{0,1,2}), in the order of _assemble_V
    v_r, v_c = [], []
    for t, rows in enumerate(plan["socx_rows"]):
        v_r.extend(int(r) for r in rows)   # v column
        v_c.extend([2 * t] * len(rows))
    for t, rows in enumerate(plan["socx_rows"]):
        v_r.extend(int(r) for r in rows)   # u column
        v_c.extend([2 * t + 1] * len(rows))
    for t in range(ngx):
        r1 = plan["gpx_rows1"][t]
        r2 = plan["gpx_rows2"][t]
        base = 2 * nx + 3 * t
        v_r.extend(int(r) for r in r1)     # q column (dim1 rows)
        v_c.extend([base] * len(r1))
        v_r.extend(int(r) for r in r2)     # r column (dim2 rows)
        v_c.extend([base + 1] * len(r2))
        v_r.extend(int(r) for r in r1)     # p column (all rows)
        v_c.extend([base + 2] * len(r1))
        v_r.extend(int(r) for r in r2)
        v_c.extend([base + 2] * len(r2))
    dsigns_ext_np = np.concatenate([
        np.tile([-1.0, 1.0], nx),          # SOC (v, u)
        np.tile([-1.0, -1.0, 1.0], ngx),   # GenPow (q, r, p)
    ]) if nw else np.zeros(0)
    # the explicit rows of each slab, by local index, in shard order
    m_loc = m // ndev
    ex_local = [torch.as_tensor(
        ex_idx_np[(ex_idx_np >= i * m_loc) & (ex_idx_np < (i + 1) * m_loc)]
        - i * m_loc, device=dev) for i, dev in enumerate(devices)]

    def on_home(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=home)

    i64 = torch.int64
    el_mask = on_home(~ex_mask_np, F64)
    ex_idx = on_home(ex_idx_np, i64)
    ex_pos = on_home(ex_pos_np, i64)
    hex_i, hex_j = on_home(hex_i_np, i64), on_home(hex_j_np, i64)
    hex_off = on_home(hex_off_np, i64)
    v_r_t, v_c_t = on_home(v_r, i64), on_home(v_c, i64)
    dsigns_ext = on_home(dsigns_ext_np, F64)
    eye_n = torch.eye(n, dtype=F64, device=home)
    eye_ex = torch.eye(mex, dtype=F64, device=home)

    def _assemble_V(socx, gpx):
        """(m, nw) expansion columns from the per-cone scaled vectors
        (already carrying the -eta^2 / -sqrt(mu) K scaling); every entry
        is written once."""
        vals = [s[1][0] for s in socx]                  # v columns
        vals += [s[0][0] for s in socx]                 # u columns
        for g in gpx:
            vals.extend((g[0][0], g[1][0], g[2][0]))    # q, r, p
        V = torch.zeros(m, nw, dtype=F64, device=home)
        V[v_r_t, v_c_t] = torch.cat(vals)
        return V

    def _assemble_E(socx, gpx):
        return torch.cat([s[2][0] for s in socx] + [g[3][0] for g in gpx])

    def _assemble_Hex(blk_vals):
        """The explicit rows' Hs, both triangles, every entry written
        once (the blocks are disjoint)."""
        Hex = torch.zeros(mex, mex, dtype=F64, device=home)
        if blk_vals.numel():
            Hex[hex_i, hex_j] = blk_vals
            Hex[hex_j[hex_off], hex_i[hex_off]] = blk_vals[hex_off]
        return Hex

    def _explicit_rows(A):
        """A's explicit rows (mex, n) on the home device, in row order."""
        return A.gather([a.index_select(0, loc)
                         for a, loc in zip(A.slabs, ex_local)])

    def factorize(P, A, hs_parts):
        hs_diag, blk_vals, socx, gpx = hs_parts
        Pm = P[0]
        hs_diag = hs_diag[0]
        blk_vals = blk_vals[0]
        V = _assemble_V(socx, gpx) if nw else None
        E = _assemble_E(socx, gpx) if nw else hs_diag.new_zeros(0)
        Hex = _assemble_Hex(blk_vals)

        if reg_enable:
            dmax = torch.stack([
                _inf_norm(torch.diagonal(Pm)), _inf_norm(hs_diag),
                _inf_norm(E), _inf_norm(torch.diagonal(Hex)),
            ]).amax()
            eps = eps_const + eps_prop * dmax
        else:
            # the elimination needs D invertible
            eps = hs_diag.new_tensor(eps_const)

        # masked reciprocal: explicit rows contribute nothing
        dinv = el_mask / (hs_diag + eps)
        dinv_s = A.split(dinv)
        Vs = ShardedRows.from_home(V, A) if nw else None

        s_parts, b_parts, c_parts = [], [], []
        for i, (a, di) in enumerate(zip(A.slabs, dinv_s)):
            AtD = a.T * di                      # (n, m_loc)
            s_parts.append(AtD @ a)
            if nw:
                v = Vs.slabs[i]
                b_parts.append(AtD @ v)
                c_parts.append((v.T * di) @ v)
        S = Pm + eps * eye_n + A.reduce(s_parts)
        if nw:
            B = A.reduce(b_parts)
            C = A.reduce(c_parts) + torch.diag(E + dsigns_ext * eps)
        else:
            B = hs_diag.new_zeros(n, 0)
            C = hs_diag.new_zeros(0, 0)
        if mex:
            Aex = _explicit_rows(A)
            Hex_reg = Hex + eps * eye_ex
        else:
            Aex = hs_diag.new_zeros(0, n)
            Hex_reg = hs_diag.new_zeros(0, 0)

        # the dense saddle, SPD block leading
        if nw or mex:
            M = torch.cat([
                torch.cat([S, B, Aex.T], dim=1),
                torch.cat([B.T, C, hs_diag.new_zeros(nw, mex)], dim=1),
                torch.cat([Aex, hs_diag.new_zeros(mex, nw), -Hex_reg],
                          dim=1),
            ], dim=0)
        else:
            M = S
        Kinv = saddle_inverse(M)
        ok = torch.isfinite(Kinv).all() & torch.isfinite(dinv).all()
        if refine_regularised:
            # the refinement's operator is the saddle that was inverted
            Pm = Pm + eps * eye_n
            hs_diag = hs_diag + eps
            Hex = Hex_reg
            E = E + dsigns_ext * eps
        return {"Kinv": Kinv, "A": A, "dinv": dinv, "hs_diag": hs_diag,
                "V": Vs, "E": E, "Hex": Hex, "P": Pm}, ok[None]

    factorize.structured_hs = True

    def _scatter_ex(v_ex):
        """An explicit-row vector (mex,) at its rows of an m-vector (the
        other rows are masked off by the caller)."""
        return v_ex[ex_pos] if mex else v_ex.new_zeros(m)

    def _raw_solve(fac, rx, rz, rt=None):
        """One augmented-saddle solve -> (x, z, t); rt is the expansion
        rows' right-hand side (zero on primary solves)."""
        A, V = fac["A"], fac["V"]
        w = fac["dinv"] * rz
        atw = A.cols(w)
        vtw = V.cols(w) if nw else w.new_zeros(0)
        if rt is not None:
            vtw = vtw + rt
        rhs = (torch.cat([rx + atw, vtw, rz[ex_idx]]) if (nw or mex)
               else rx + atw)
        sol = fac["Kinv"] @ rhs
        x = sol[:n]
        tt = sol[n:n + nw]
        fwd = A.rows(x)
        if nw:
            fwd = fwd + V.rows(tt)
        z_el = fac["dinv"] * (fwd - rz)
        z = z_el * el_mask + _scatter_ex(sol[n + nw:]) * (1.0 - el_mask)
        return x, z, tt

    def _kkt_matvec(fac, x, z, tt):
        """The unregularised augmented operator applied to (x, z, t)."""
        A, V = fac["A"], fac["V"]
        hz_full = (_scatter_ex(fac["Hex"] @ z[ex_idx]) if mex
                   else z.new_zeros(m))
        top = fac["P"] @ x + A.cols(z)
        hz = el_mask * fac["hs_diag"] * z + (1.0 - el_mask) * hz_full
        bot = A.rows(x) - hz
        if nw:
            bot = bot + V.rows(tt)
            ext = V.cols(z * el_mask) + fac["E"] * tt
        else:
            ext = z.new_zeros(0)
        return top, bot, ext

    def _errnorm(ex, ez, et):
        return torch.stack([_inf_norm(ex), _inf_norm(ez),
                            _inf_norm(et)]).amax()

    def solve(fac, rx, rz):
        rx, rz = rx[0], rz[0]
        x, z, tt = _raw_solve(fac, rx, rz)
        nir = 0
        if not ir_enable:
            ok = torch.isfinite(x).all() & torch.isfinite(z).all()
            return (x[None], z[None], ok[None],
                    torch.zeros(1, dtype=torch.int32, device=home))

        tol = ir_abstol + ir_reltol * torch.maximum(_inf_norm(rx),
                                                    _inf_norm(rz))

        def residual(x, z, tt):
            tx, tz, te = _kkt_matvec(fac, x, z, tt)
            return rx - tx, rz - tz, -te

        e = residual(x, z, tt)
        norme = _errnorm(*e)
        ok = torch.isfinite(norme)
        stop = torch.zeros_like(ok)
        # one host sync a trip, as the reference's while_loop tests it
        while nir < ir_maxiter and bool(~stop & ok & (norme > tol)):
            dx, dz, dt = _raw_solve(fac, e[0], e[1], e[2])
            xn, zn, tn = x + dx, z + dz, tt + dt
            en = residual(xn, zn, tn)
            normen = _errnorm(*en)
            ratio = norme / torch.where(normen > 0, normen, 1e-300)
            accept = ratio > 1.0
            x, z, tt = (torch.where(accept, a, b_) for a, b_ in
                        ((xn, x), (zn, z), (tn, tt)))
            e = tuple(torch.where(accept, a, b_) for a, b_ in zip(en, e))
            norme = torch.where(accept, normen, norme)
            nir += 1
            stop = ~(ratio > ir_stopratio)
            ok = torch.isfinite(normen)
        ok = ok & torch.isfinite(norme)
        return (x[None], z[None], ok[None],
                torch.full((1,), nir, dtype=torch.int32, device=home))

    return factorize, solve
