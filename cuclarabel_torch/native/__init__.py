"""The native (C++) sparse LDL^T, loaded through ctypes.

A copy of `cuclarabel_tpu/native/__init__.py` over a copy of its
`ldl.cpp`: a left-looking sparse quasidefinite LDL^T with precomputed
symbolic structure and signed dynamic regularization, and a greedy
minimum-degree ordering (the header of `ldl.cpp` gives the algorithms'
provenance).  The reference's QDLDL backend (directldl_qdldl.jl:10-96)
is its counterpart; `kkt/sparse_cpu.py` runs it on the host for
direct_solve_method="qdldl", `kkt/sparse_symbolic.py` takes its
minimum-degree ordering and `chordal/graph.py` its symbolic fill.

The library is compiled with the system g++ on first use, into `build/`
beside the package (git ignores it), under a name that carries a hash
of the source and the flags, so an edited source is never served by a
stale build.  Where the reference degrades to pure-Python paths when the
build fails, here a failed build raises with the compiler's output.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "ldl.cpp"
BUILD_DIR = _HERE.parents[1] / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp")

_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcuclarabel_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ldl.cpp unless a build of this source exists; raise with
    the compiler's output when it fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"the native LDL library cannot be built: "
                           f"{' '.join(cmd)}: {exc}") from exc
    try:
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed with exit code {res.returncode}:\n"
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        # atomic: a concurrent loader sees all or nothing
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


@functools.lru_cache(maxsize=1)
def get_lib() -> ctypes.CDLL:
    """The native library, built on first use (raises if it cannot be)."""
    lib = ctypes.CDLL(str(build()))
    lib.ldl_analyze.restype = ctypes.c_int64
    lib.ldl_analyze.argtypes = [ctypes.c_int64, _I64, _I64, _I64, _I64, _I64]
    lib.ldl_pattern.restype = None
    lib.ldl_pattern.argtypes = [
        ctypes.c_int64, _I64, _I64, _I64, _I64,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
    ]
    lib.ldl_refactor_mt.restype = ctypes.c_int64
    lib.ldl_refactor_mt.argtypes = [
        ctypes.c_int64, _F64,
        _I64, _I64, _I64,
        _I64, _I64, _I64,
        _I64, _I64, _F64,
        _F64, _F64, _I64,
        ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        _I64, _I64, ctypes.c_int64, ctypes.c_int64, _F64,
    ]
    lib.ldl_refactor.restype = ctypes.c_int64
    lib.ldl_refactor.argtypes = [
        ctypes.c_int64, _F64,
        _I64, _I64, _I64,
        _I64, _I64,
        _I64, _I64, _F64,
        _F64, _F64, _I64,
        ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        _I64, _F64,
    ]
    lib.ldl_solve.restype = None
    lib.ldl_solve.argtypes = [ctypes.c_int64, _I64, _I64, _F64, _F64, _F64]
    lib.mindeg_order.restype = None
    lib.mindeg_order.argtypes = [ctypes.c_int64, _I64, _I64, _I64]
    return lib


def _ptr_i(a):
    return a.ctypes.data_as(_I64)


def _ptr_f(a):
    return a.ctypes.data_as(_F64)


class LDLFactor:
    """Symbolic + numeric LDL^T of an upper-triangular CSC matrix.

    Behavioral parity with the reference QDLDL backend
    (directldl_qdldl.jl:10-96): symbolic analysis once, numeric
    refactorization in place, signed dynamic regularization, solve.
    The implementation is the left-looking sweep of ldl.cpp (symbolic
    row/column patterns precomputed; no elimination walks at numeric
    time)."""

    def __init__(self, n, Ap, Ai, dsigns, reg_enable=True,
                 eps=1e-13, delta=2e-7, max_threads=1):
        lib = get_lib()
        self.lib = lib
        self.n = int(n)
        self.Ap = np.ascontiguousarray(Ap, dtype=np.int64)
        self.Ai = np.ascontiguousarray(Ai, dtype=np.int64)
        self.dsigns = np.ascontiguousarray(dsigns, dtype=np.int64)
        self.reg_enable = 1 if reg_enable else 0
        self.eps = float(eps)
        self.delta = float(delta)

        work = np.zeros(self.n, dtype=np.int64)
        self.Lcnt = np.zeros(self.n, dtype=np.int64)
        self.etree = np.zeros(self.n, dtype=np.int64)
        nnzL = lib.ldl_analyze(
            self.n, _ptr_i(self.Ap), _ptr_i(self.Ai), _ptr_i(work),
            _ptr_i(self.Lcnt), _ptr_i(self.etree),
        )
        if nnzL < 0:
            raise ValueError("matrix is not upper triangular CSC")
        self.nnzL = int(nnzL)
        nnzA = int(self.Ap[self.n])
        self.Lp = np.zeros(self.n + 1, dtype=np.int64)
        self.Li = np.zeros(self.nnzL, dtype=np.int64)
        self.Rp = np.zeros(self.n + 1, dtype=np.int64)
        self.Rj = np.zeros(self.nnzL, dtype=np.int64)
        self.Up = np.zeros(self.n + 1, dtype=np.int64)
        self.Uj = np.zeros(nnzA, dtype=np.int64)
        self.Usrc = np.zeros(nnzA, dtype=np.int64)
        pwork = np.zeros(2 * self.n, dtype=np.int64)
        self.Rpos = np.zeros(self.nnzL, dtype=np.int64)
        lib.ldl_pattern(
            self.n, _ptr_i(self.Ap), _ptr_i(self.Ai), _ptr_i(self.etree),
            _ptr_i(self.Lcnt), _ptr_i(self.Lp), _ptr_i(self.Li),
            _ptr_i(self.Rp), _ptr_i(self.Rj), _ptr_i(self.Rpos),
            _ptr_i(self.Up), _ptr_i(self.Uj), _ptr_i(self.Usrc),
            _ptr_i(pwork),
        )
        self.Lx = np.zeros(self.nnzL)
        self.D = np.zeros(self.n)
        self.Dinv = np.zeros(self.n)
        self._head = np.zeros(self.n, dtype=np.int64)

        # thread count: 0 = auto = sequential.  The reference measured no
        # speed-up of the level-parallel sweep on grid KKTs up to
        # N = 20001 on a 4-core host (the left-looking column gathers
        # are memory-bound); an explicit max_threads > 1 is honored
        # (settings.jl:108-110).
        if max_threads == 0:
            max_threads = 1
        self.nthreads = max(1, int(max_threads))
        if self.nthreads > 1:
            # etree levels: parent > child always, so one ascending
            # pass computes level[k] = 1 + max(level[children])
            level = np.zeros(self.n, dtype=np.int64)
            et = self.etree
            for k in range(self.n):
                p = et[k]
                if p >= 0 and level[p] <= level[k]:
                    level[p] = level[k] + 1
            nlevels = int(level.max()) + 1 if self.n else 1
            # chain-like etrees (average level width below ~2 columns
            # per thread) have no exploitable level parallelism — the
            # per-level barrier would dominate; stay sequential
            if self.n / max(nlevels, 1) < 2 * self.nthreads:
                self.nthreads = 1
            else:
                order = np.argsort(level, kind="stable").astype(np.int64)
                counts = np.bincount(level, minlength=nlevels)
                self._level_cols = np.ascontiguousarray(order)
                self._level_starts = np.concatenate(
                    [[0], np.cumsum(counts)]).astype(np.int64)
                self._nlevels = nlevels
        self._acc = np.zeros(self.nthreads * self.n)

    def refactor(self, Ax) -> bool:
        """Numeric refactorization with the cached symbolic structure."""
        Ax = np.ascontiguousarray(Ax, dtype=np.float64)
        if self.nthreads > 1:
            pos = self.lib.ldl_refactor_mt(
                self.n, _ptr_f(Ax),
                _ptr_i(self.Up), _ptr_i(self.Uj), _ptr_i(self.Usrc),
                _ptr_i(self.Rp), _ptr_i(self.Rj), _ptr_i(self.Rpos),
                _ptr_i(self.Lp), _ptr_i(self.Li), _ptr_f(self.Lx),
                _ptr_f(self.D), _ptr_f(self.Dinv), _ptr_i(self.dsigns),
                self.reg_enable, self.eps, self.delta,
                _ptr_i(self._level_cols), _ptr_i(self._level_starts),
                self._nlevels, self.nthreads, _ptr_f(self._acc),
            )
        else:
            pos = self.lib.ldl_refactor(
                self.n, _ptr_f(Ax),
                _ptr_i(self.Up), _ptr_i(self.Uj), _ptr_i(self.Usrc),
                _ptr_i(self.Rp), _ptr_i(self.Rj),
                _ptr_i(self.Lp), _ptr_i(self.Li), _ptr_f(self.Lx),
                _ptr_f(self.D), _ptr_f(self.Dinv), _ptr_i(self.dsigns),
                self.reg_enable, self.eps, self.delta,
                _ptr_i(self._head), _ptr_f(self._acc),
            )
        # success iff all D finite (directldl_qdldl.jl:79)
        return pos >= 0 and bool(np.all(np.isfinite(self.D)))

    def solve(self, b: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(b, dtype=np.float64).copy()
        self.lib.ldl_solve(
            self.n, _ptr_i(self.Lp), _ptr_i(self.Li), _ptr_f(self.Lx),
            _ptr_f(self.Dinv), _ptr_f(x),
        )
        return x


def mindeg_ordering(n, Ap, Ai) -> np.ndarray:
    """Greedy minimum-degree ordering via the native kernel (full CSC
    pattern input)."""
    lib = get_lib()
    Ap = np.ascontiguousarray(Ap, dtype=np.int64)
    Ai = np.ascontiguousarray(Ai, dtype=np.int64)
    perm = np.zeros(n, dtype=np.int64)
    lib.mindeg_order(int(n), _ptr_i(Ap), _ptr_i(Ai), _ptr_i(perm))
    return perm
