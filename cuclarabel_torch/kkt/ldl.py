"""Batched f64 LDL^T KKT engine: the hand-written Hopper kernels of
`csrc/ldl.cu` (N <= 128) and `csrc/ldl_wide.cu` (N > 128) and their plain
PyTorch versions.

The counterpart of `cuclarabel_tpu/kkt/pallas_dd.py`.  Layout is
batch-first: K and L are (B, N, N), D^-1 is (B, N), right-hand sides are
(B, N) or (B, N, R) with R in {1, 2}; everything is float64, any N >= 1.

  ldl_factor(K, reg)                     -> (L, Dinv, ok)
  ldl_solve(L, Dinv, b)                  -> x
  kkt_residual(K, x, b)                  -> r = b - K x
  ldl_solve_refine(K, L, Dinv, b, npass) -> (x, r)

L is the strict-lower unit factor (zeros on and above the diagonal) of
K + diag(reg) = (I + L) D (I + L)^T, and Dinv holds D^-1, as in the
reference.  K is symmetric: ldl_factor, kkt_residual and
ldl_solve_refine read only its lower triangle, kernels and plain
versions alike.  Each wrapper takes its plain version when its tensors lie on
the CPU and launches its CUDA kernel when they lie on a CUDA device;
there is no fallback from one to the other.  On the card each wrapper
launches its narrow form at N <= NARROW_MAX_N = 128 and its wide form
above (one block per problem: `csrc/ldl_wide.cu`).  Above 128 the
factor, the substitution and the refined solve each have two forms,
which their launchers choose from N (and R) and the card's shared
memory (`factor_form`, `solve_form` and `refine_form` ask them): the
problem's triangle in shared memory where it fits ("shared"; on an H100
the factor up to N = 220, the substitution up to 240, the refined solve
up to 233 at R = 1 and 226 at R = 2), read from device memory above
("streaming"); the refined solve runs its residuals through
kkt_residual's tiled body.  The wrappers pass no form: the launcher's
choice is the only one.  `LAUNCHES` counts kernel launches,
keyed by "<name>/r<R>" for a narrow form and "<name>_wide/r<R>" for a
wide one, and `PLAIN_CALLS` calls of the plain versions, keyed by
"<name>/r<R>" at every N, so a run can show which path it took; both
stay exact when several host threads launch at once, and
`LAUNCHES.by_device` splits the launches by card.
"""

import collections
import threading

import torch

from . import _build

# the largest N of the narrow forms (csrc/ldl.cu, csrc/ldl_f32.cu)
NARROW_MAX_N = 128


class Counts(collections.Counter):
    """A Counter that host threads bump under one lock (a batch over
    several cards runs one thread per card); `by_device` holds each
    device's own counts, keyed by str(device)."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self.by_device = {}

    def add(self, key, device=None):
        with self._lock:
            self[key] += 1
            if device is not None:
                self.by_device.setdefault(
                    str(device), collections.Counter())[key] += 1

    def clear(self):
        with self._lock:
            super().clear()
            self.by_device = {}


LAUNCHES = Counts()
PLAIN_CALLS = Counts()


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


# ---------------------------------------------------------------------
# plain PyTorch versions (batched loops over pivots)
# ---------------------------------------------------------------------

def _sym_from_lower(K):
    """The symmetric matrix whose lower triangle is K's (the kernels of
    ldl_factor, kkt_residual and ldl_solve_refine read only that
    triangle)."""
    return torch.tril(K) + torch.tril(K, -1).transpose(1, 2)


def _as_rhs(b):
    """(B, N) -> (B, N, 1) view; (B, N, R) unchanged."""
    return b.unsqueeze(-1) if b.dim() == 2 else b


def _factor(K, reg):
    """Plain pivot-free LDL^T of K + diag(reg) (reg None: of K), in K's
    dtype.  Reads K's lower triangle.  A pivot that cancels to exactly
    zero takes its row's regularization reg[j] instead (without reg it
    stays zero, and D^-1 is not finite).  The reference's factor has no
    such guard: its double-float rounding leaves such a pivot a tiny
    nonzero (a very large D^-1), where f64 gives exactly zero."""
    B, N, _ = K.shape
    A = _sym_from_lower(K)
    if reg is not None:
        A = A + torch.diag_embed(reg)
    L = torch.zeros_like(K)
    Dinv = K.new_empty(B, N)
    for j in range(N):
        d = A[:, j, j]
        if reg is not None:
            d = torch.where(d == 0, reg[:, j], d)
        dinv = 1.0 / d
        Dinv[:, j] = dinv
        a = A[:, j + 1:, j]
        lcol = a * dinv[:, None]
        L[:, j + 1:, j] = lcol
        A[:, j + 1:, j + 1:] -= a[:, :, None] * lcol[:, None, :]
    return L, Dinv, torch.isfinite(Dinv).all(dim=1)


def _solve(L, Dinv, b):
    x = _as_rhs(b).clone()
    N = x.shape[1]
    for j in range(N - 1):  # forward, column by column
        x[:, j + 1:, :] -= L[:, j + 1:, j, None] * x[:, j, None, :]
    x *= Dinv[:, :, None]
    for i in range(N - 1, 0, -1):  # backward, row by row
        x[:, :i, :] -= L[:, i, :i, None] * x[:, i, None, :]
    return x.reshape(b.shape)


def _residual(K, x, b):
    """b - K x, each right-hand side summed as one alone is, so that a
    2-RHS residual equals two 1-RHS ones bit for bit, as the kernels'
    do (a sum over dim 2 of a (B, N, N, 2) product runs in another
    order)."""
    xr = _as_rhs(x)
    Kx = torch.cat([(K[:, :, :, None] * xr[:, None, :, t:t + 1]).sum(dim=2)
                    for t in range(xr.shape[2])], dim=2)
    return (_as_rhs(b) - Kx).reshape(b.shape)


def _solve_refine(K, L, Dinv, b, npass):
    Ks = _sym_from_lower(K)
    br = _as_rhs(b)
    x = _solve(L, Dinv, br)
    r = _residual(Ks, x, br)
    ne = r.abs().amax(dim=1)  # (B, R), NaN-propagating
    for _ in range(npass):
        xn = x + _solve(L, Dinv, r)
        en = _residual(Ks, xn, br)
        nen = en.abs().amax(dim=1)
        acc = nen < ne
        x = torch.where(acc[:, None, :], xn, x)
        r = torch.where(acc[:, None, :], en, r)
        ne = torch.where(acc, nen, ne)
    return x.reshape(b.shape), r.reshape(b.shape)


def _r(b):
    return 1 if b.dim() == 2 else b.shape[-1]


def ldl_factor_plain(K, reg):
    PLAIN_CALLS.add("ldl_factor/r1")
    return _factor(K, reg)


def ldl_solve_plain(L, Dinv, b):
    PLAIN_CALLS.add(f"ldl_solve/r{_r(b)}")
    return _solve(L, Dinv, b)


def kkt_residual_plain(K, x, b):
    PLAIN_CALLS.add(f"kkt_residual/r{_r(b)}")
    return _residual(_sym_from_lower(K), x, b)


def ldl_solve_refine_plain(K, L, Dinv, b, npass):
    PLAIN_CALLS.add(f"ldl_solve_refine/r{_r(b)}")
    return _solve_refine(K, L, Dinv, b, npass)


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------

def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(
        f"operands must all lie on the CPU or all on one CUDA device, "
        f"got {sorted(str(t.device) for t in ts)}")


def _check(name, t, shape, dtype=torch.float64):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dims(M, name):
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"{name} must be (B, N, N), got {tuple(M.shape)}")
    B, N = M.shape[0], M.shape[1]
    if N < 1:
        raise ValueError(f"the LDL^T kernels take N >= 1, got {N}")
    return B, N


def wide(N) -> bool:
    """Whether the wrappers launch the wide forms at N."""
    return N > NARROW_MAX_N


def _form(fn, what, *args):
    rc = getattr(_build.load(), fn)(*args)
    if rc < 0:
        raise RuntimeError(f"{what}: CUDA error {-rc}")
    return "shared" if rc else "streaming"


def factor_form(N, dtype=torch.float64):
    """The form of the wide factor (f64, or f32: ldl_f32) that its
    launcher picks at N (above NARROW_MAX_N) on the current CUDA device:
    "shared", K's triangle factored in shared memory (the narrow
    factor's blocked body), where its layout fits what one block may
    have; "streaming", the trailing triangle kept in L's rows in device
    memory, above."""
    word = torch.empty((), dtype=dtype).element_size()
    return _form("cc_factor_form_wide", f"factor_form({N}, {dtype})", N,
                 word)


def solve_form(N, R=1, dtype=torch.float64):
    """The form of the wide substitution that its launcher picks at N
    (above NARROW_MAX_N), R on the current CUDA device: "shared", L
    copied into shared memory panel by panel and swept there by one
    warp, where it fits; "streaming", L read from device memory by the
    block's panels, above."""
    word = torch.empty((), dtype=dtype).element_size()
    return _form("cc_solve_form_wide", f"solve_form({N}, {R}, {dtype})", N,
                 R, word)


def refine_form(N, R):
    """The form of the wide refined solve that its launcher picks at N
    (above NARROW_MAX_N), R on the current CUDA device: "shared", L
    copied once into shared memory and read there by every sweep, where
    it fits what one block may have; "streaming", L read from device
    memory by each sweep, above."""
    return _form("cc_refine_form_wide", f"refine_form({N}, {R})", N, R)


def launch_key(name, N, R):
    """The LAUNCHES key of a kernel launch of `name` at N, R."""
    return f"{name}_wide/r{R}" if wide(N) else f"{name}/r{R}"


def _rhs_shape(b, B, N, name):
    if b.dim() == 2:
        shape = (B, N)
    elif b.dim() == 3 and b.shape[-1] in (1, 2):
        shape = (B, N, b.shape[-1])
    else:
        raise ValueError(f"{name} must be (B, N) or (B, N, R) with R in "
                         f"(1, 2), got {tuple(b.shape)}")
    return shape


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def ldl_factor(K, reg):
    """Pivot-free LDL^T of K + diag(reg).  K: (B, N, N), of which only
    the lower triangle is read; reg: (B, N).  Returns L (B, N, N)
    strict-lower unit factor, Dinv (B, N) and ok (B,) bool = all of the
    problem's D^-1 finite."""
    if _on_cpu(K, reg):
        return ldl_factor_plain(K, reg)
    B, N = _dims(K, "K")
    _check("K", K, (B, N, N))
    _check("reg", reg, (B, N))
    L = torch.empty_like(K)
    Dinv = torch.empty_like(reg)
    ok = torch.empty(B, dtype=torch.bool, device=K.device)
    lib = _build.load()
    fn = lib.cc_ldl_factor_wide if wide(N) else lib.cc_ldl_factor
    with torch.cuda.device(K.device):
        rc = fn(K.data_ptr(), reg.data_ptr(), L.data_ptr(), Dinv.data_ptr(),
                ok.data_ptr(), B, N, _stream(K))
    _raise_on(rc, "ldl_factor")
    LAUNCHES.add(launch_key("ldl_factor", N, 1), K.device)
    return L, Dinv, ok


def ldl_solve(L, Dinv, b):
    """x with (I + L) D (I + L)^T x = b; b (B, N) or (B, N, R)."""
    if _on_cpu(L, Dinv, b):
        return ldl_solve_plain(L, Dinv, b)
    B, N = _dims(L, "L")
    shape = _rhs_shape(b, B, N, "b")
    _check("L", L, (B, N, N))
    _check("Dinv", Dinv, (B, N))
    _check("b", b, shape)
    R = _r(b)
    x = torch.empty_like(b)
    lib = _build.load()
    fn = lib.cc_ldl_solve_wide if wide(N) else lib.cc_ldl_solve
    with torch.cuda.device(L.device):
        rc = fn(L.data_ptr(), Dinv.data_ptr(), b.data_ptr(), x.data_ptr(), B,
                N, R, _stream(L))
    _raise_on(rc, "ldl_solve")
    LAUNCHES.add(launch_key("ldl_solve", N, R), L.device)
    return x


def kkt_residual(K, x, b):
    """r = b - K x; K (B, N, N) symmetric, of which only the lower
    triangle is read; x, b (B, N) or (B, N, R)."""
    if _on_cpu(K, x, b):
        return kkt_residual_plain(K, x, b)
    B, N = _dims(K, "K")
    shape = _rhs_shape(b, B, N, "b")
    _check("K", K, (B, N, N))
    _check("x", x, shape)
    _check("b", b, shape)
    R = _r(b)
    r = torch.empty_like(b)
    lib = _build.load()
    fn = lib.cc_kkt_residual_wide if wide(N) else lib.cc_kkt_residual
    with torch.cuda.device(K.device):
        rc = fn(K.data_ptr(), x.data_ptr(), b.data_ptr(), r.data_ptr(), B, N,
                R, _stream(K))
    _raise_on(rc, "kkt_residual")
    LAUNCHES.add(launch_key("kkt_residual", N, R), K.device)
    return r


def ldl_solve_refine(K, L, Dinv, b, npass):
    """Fused refined solve: x = solve(b), then `npass` passes of
    x' = x + solve(b - K x), each accepted per right-hand side only where
    max|b - K x'| < max|b - K x| strictly.  K must be symmetric (its
    lower triangle is read).  Returns the accepted x and r = b - K x."""
    if _on_cpu(K, L, Dinv, b):
        return ldl_solve_refine_plain(K, L, Dinv, b, npass)
    B, N = _dims(K, "K")
    shape = _rhs_shape(b, B, N, "b")
    _check("K", K, (B, N, N))
    _check("L", L, (B, N, N))
    _check("Dinv", Dinv, (B, N))
    _check("b", b, shape)
    if npass < 0:
        raise ValueError(f"npass must be >= 0, got {npass}")
    R = _r(b)
    x = torch.empty_like(b)
    r = torch.empty_like(b)
    lib = _build.load()
    fn = lib.cc_ldl_solve_refine_wide if wide(N) else lib.cc_ldl_solve_refine
    with torch.cuda.device(K.device):
        rc = fn(K.data_ptr(), L.data_ptr(), Dinv.data_ptr(), b.data_ptr(),
                x.data_ptr(), r.data_ptr(), B, N, R, int(npass), _stream(K))
    _raise_on(rc, "ldl_solve_refine")
    LAUNCHES.add(launch_key("ldl_solve_refine", N, R), K.device)
    return x, r
