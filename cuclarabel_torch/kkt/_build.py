"""Build and load the port's CUDA kernels (`csrc/*.cu`).

`nvcc` compiles each source to an object, all sources at once in
parallel, and links the objects into one shared library with a plain C
interface, which `ctypes` loads; no PyTorch headers are involved, so a
build takes seconds.  The build happens the first time a kernel is used
on a CUDA tensor, into `build/` beside the package (git ignores it).
The library's name carries a hash of the sources, headers and flags, so
an edited source is never served by a stale build.  A failed build
raises.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
SOURCES = (CSRC / "ldl.cu", CSRC / "ldl_f32.cu", CSRC / "ldl_wide.cu",
           CSRC / "probes.cu", CSRC / "segsum.cu")
HEADERS = (CSRC / "ldl_core.cuh",)
BUILD_DIR = PACKAGE_DIR.parent / "build"
# -fmad=false: no contraction of a multiply and an add into one FMA, so
# the factor and the substitution round each operation as their plain
# PyTorch versions do and agree with them bit for bit.  With FMAs the
# two differ by rounding alone, but a nearly cancelling pivot of an
# unscaled K (N = 128, Hs spread 1e+-4) amplified that to 1e-9 relative
# on an H100, above the 1e-10 bar the kernels are held to.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + (
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/ldl.cu, csrc/ldl_f32.cu, csrc/ldl_wide.cu,
# csrc/probes.cu and csrc/segsum.cu (pointers, then ints, then the
# stream; the cc_occupancy* functions: ints, then two int pointers).
# Each wide form (N > 128) has its narrow form's signature;
# cc_factor_form_wide(n, word), cc_solve_form_wide(n, r, word) and
# cc_refine_form_wide(n, r) return the form the wide launchers pick
# (word: the element's bytes).
SIGNATURES = {
    "cc_ldl_factor": (_P, _P, _P, _P, _P, _I, _I, _P),
    "cc_ldl_solve": (_P, _P, _P, _P, _I, _I, _I, _P),
    "cc_kkt_residual": (_P, _P, _P, _P, _I, _I, _I, _P),
    "cc_ldl_solve_refine": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "cc_ldl_factor_f32": (_P, _P, _P, _I, _I, _P),
    "cc_ldl_solve_f32": (_P, _P, _P, _P, _I, _I, _P),
    "cc_ldl_factor_wide": (_P, _P, _P, _P, _P, _I, _I, _P),
    "cc_ldl_solve_wide": (_P, _P, _P, _P, _I, _I, _I, _P),
    "cc_kkt_residual_wide": (_P, _P, _P, _P, _I, _I, _I, _P),
    "cc_ldl_solve_refine_wide": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "cc_factor_form_wide": (_I, _I),
    "cc_solve_form_wide": (_I, _I, _I),
    "cc_refine_form_wide": (_I, _I),
    "cc_ldl_factor_wide_f32": (_P, _P, _P, _I, _I, _P),
    "cc_ldl_solve_wide_f32": (_P, _P, _P, _P, _I, _I, _P),
    "cc_occupancy": (_I, _I, _I, _P, _P),
    "cc_occupancy_f32": (_I, _P, _P),
    "cc_occupancy_f32_solve": (_I, _P, _P),
    "cc_occupancy_wide": (_I, _I, _I, _P, _P),
    "cc_probe_chain": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "cc_probe_issue": (_P, _P, _P, _I, _I, _I, _P),
    "cc_segment_sum": (_P, _P, _P, _I, _I, _I, _I, _P),
}


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path("/usr/local/cuda/bin/nvcc")
        if cand.is_file() and os.access(cand, os.X_OK):
            path = str(cand)
    if path is None:
        raise RuntimeError(
            "nvcc not found on PATH or under /usr/local/cuda/bin: the "
            "CUDA kernels of cuclarabel_torch cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcuclarabel_ldl_{h.hexdigest()[:16]}.so"


def _run(cmd):
    """Run one nvcc command to its end; raise with its output on failure.
    Returns the output."""
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n"
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def build() -> dict:
    """Compile the kernels unless a build of these sources exists.
    Returns {"path", "seconds", "log"} (log: nvcc's and ptxas' report,
    kept beside the library, so a found build returns its log too)."""
    path = library_path()
    log_path = path.with_suffix(".log")
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": path, "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        # one nvcc per source, all started together
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            logs = list(pool.map(
                _run, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                       for src, o in zip(SOURCES, objs)]))
        logs.append(_run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs)]))
        # the log first: a loader that finds the library finds its log
        tmp_log.write_text("".join(logs))
        os.replace(tmp_log, log_path)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        tmp_log.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return {"path": path, "seconds": time.perf_counter() - t0,
            "log": "".join(logs)}


_PTXAS_NAME = re.compile(
    r"(?:Compiling entry function '|Function properties for )([^'\s]+)")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: {"registers", "stack_frame", "spill_stores",
    "spill_loads"}} (bytes per thread) from ptxas' -v report in a
    build()'s log; a key is missing where ptxas printed no such line."""
    out = {}
    name = None
    for line in log.splitlines():
        if m := _PTXAS_NAME.search(line):
            name = m.group(1)
            out.setdefault(name, {})
        elif name is not None and (m := _PTXAS_FRAME.search(line)):
            out[name].update(zip(("stack_frame", "spill_stores",
                                  "spill_loads"), map(int, m.groups())))
        elif name is not None and (m := _PTXAS_REGS.search(line)):
            out[name]["registers"] = int(m.group(1))
    return out


_LOAD_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (once, also when several
    host threads ask for it at the same time)."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
