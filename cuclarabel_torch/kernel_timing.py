"""Times of the f64 LDL^T kernels (`csrc/ldl.cu`) on one card, at the
main path's shapes.

    python3 -m cuclarabel_torch.kernel_timing [--wide | --wide-library]

At N = 76 (the KKT dimension of the portfolio SOCP with nass = 32) and
each width B of WIDTHS, at N = 104 (`problems.exp_logistic(4, 10,
...)`) and each width of NONSYM_WIDTHS for the forms that path launches,
at the PSD paths' (N, B) of PSD_SHAPES for theirs, and at the wide
forms' (N, B) of WIDE_SHAPES (N = 148 and 292, above 128), every kernel
form of `kkt/ldl.py` -- ldl_factor, and ldl_solve, kkt_residual and
ldl_solve_refine (npass = 1) with R = 1 and R = 2 -- and the f32
ldl_factor_batched and ldl_solve_batched of `kkt/ldl_f32.py`, on the
same K in f32, is timed:

- ms: the kernel's own duration on the device (torch.profiler; CUDA
  events around each launch where the profiler dropped its launches,
  and then timed_by is "events"), over back-to-back launches on the
  same operands, so that below about
  B = 1000 at N = 76 K and L stay warm in the 50 MB L2 (11.8 MB each at
  B = 256);
- events_ms, at B = 4096 only: CUDA events around back-to-back calls of
  the wrapper, the measure of the earlier kernel times (below that width
  it is the host's rate of calls, not the kernel's time);
- plain_ms: CUDA events around the plain PyTorch version;

beside its bound (`work`, `bound_ms`), ptxas' registers and spill bytes
per thread from the build's log and, where the kernel library reports
it, the resident blocks and warps per SM.  Run as a script, it also
times each form with the L2 flushed before every launch (cold_ms), to
show how much the warm L2 gives; a wide kernel's line names the form its
launcher ran it in ("shared" or "streaming").  With --wide it times the
shapes of WIDE_SHAPES alone.  With --wide-library it times instead
the PyTorch calls that compute the wide forms' functions at
WIDE_LIBRARY_SHAPES (library_wide: cuSOLVER's LDL^T through torch.linalg,
a host loop over the batch of seconds at B = 4096, and baddbmm), one
JSON line each.  The module times the kernels of the
`cuclarabel_torch` it is imported from, and needs nothing of that
package but `kkt/ldl.py`, `kkt/ldl_f32.py` and `kkt/_build.py`: a copy
placed in another checkout's package times that checkout's kernels, so
that two versions can be compared on one card in one run.  Needs a CUDA
device.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .kkt import _build, ldl, ldl_f32

# H100 SXM (NVIDIA data sheet), at the full 700 W power limit: HBM3
# bandwidth, and the f64 and f32 rates outside the tensor cores in
# instructions.  The data sheet's 34 and 67 TFLOP/s count an FMA as two
# operations; the kernels build with -fmad=false (kkt/_build.py), so each
# multiply and each add is one instruction: 132 SMs x 64 f64 or 128 f32
# lanes x the 1.98 GHz boost clock.
PEAK_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 1.98e9
PEAK_F64_PER_S = SMS * 64 * SM_CLOCK_HZ
PEAK_F32_PER_S = SMS * 128 * SM_CLOCK_HZ
L2_FLUSH_BYTES = 256 << 20

# the main path's KKT blocks: n = 33 variables, m = 43 constraints
MAIN_NM = (33, 43)
WIDTHS = (4096, 256, 1)
# the nonsymmetric path's (problems.exp_logistic(4, 10, ...), N = 104),
# its widths, and the forms it launches (no pair solves)
NONSYM_NM = (34, 70)
NONSYM_WIDTHS = (4096, 1)
NONSYM_FORMS = (("ldl_factor", 1), ("ldl_solve", 1), ("kkt_residual", 1),
                ("ldl_solve_refine", 1))
# the PSD paths' (n, m) blocks and widths: the max-cut batch
# (problems.maxcut_sdp(12, B, ...), N = 90) at B = 4096 and 256, the PSD
# min-eig batch (problems.psd_min_eig(8, 256, ...), N = 73), and the
# Solver on problems.sdp_chordal_banded(11, 2, 6) after its compact
# chordal decomposition (N = 127) at B = 1; and the forms they launch
PSD_SHAPES = (((12, 78), 4096), ((12, 78), 256), ((36, 37), 256),
              ((54, 73), 1))
PSD_FORMS = NONSYM_FORMS + (("ldl_solve_refine", 2),)
# the width at which CUDA events time the kernel rather than the host
EVENTS_WIDTH = 4096
F64_FORMS = (("ldl_factor", 1), ("ldl_solve", 1), ("ldl_solve", 2),
             ("kkt_residual", 1), ("kkt_residual", 2),
             ("ldl_solve_refine", 1), ("ldl_solve_refine", 2))
FORMS = F64_FORMS + (("ldl_factor_batched", 1), ("ldl_solve_batched", 1))
# the device function of each kernel, as the profiler names it: a
# prefix, which matches the kernels with or without their last template
# argument (the slot count)
KERNEL_NAMES = {"ldl_factor": "ldl_factor_kernel",
                "ldl_solve": "ldl_solve_kernel<{R}",
                "kkt_residual": "kkt_residual_kernel<{R}",
                "ldl_solve_refine": "ldl_solve_refine_kernel<{R}",
                "ldl_factor_batched": "ldl_factor_f32_kernel",
                "ldl_solve_batched": "ldl_solve_f32_kernel<"}
# the wide forms (csrc/ldl_wide.cu), which the wrappers launch above
# N = 128: templates on the scalar type (and R)
WIDE_KERNEL_NAMES = {
    "ldl_factor": "ldl_factor_wide_kernel<double",
    "ldl_solve": "ldl_solve_wide_kernel<double, {R}",
    "kkt_residual": "kkt_residual_wide_kernel<double, {R}",
    "ldl_solve_refine": "ldl_solve_refine_wide_kernel<double, {R}",
    "ldl_factor_batched": "ldl_factor_wide_kernel<float",
    "ldl_solve_batched": "ldl_solve_wide_kernel<float"}
OCCUPANCY_ID = {"ldl_factor": 0, "ldl_solve": 1, "kkt_residual": 2,
                "ldl_solve_refine": 3}
WIDE_OCCUPANCY_ID = dict(OCCUPANCY_ID, ldl_factor_batched=4,
                         ldl_solve_batched=5)
# cc_occupancy_wide's ids of the wide kernels' shared forms
SHARED_OCCUPANCY_ID = {"ldl_solve_refine": 6, "ldl_factor": 7,
                       "ldl_solve": 8, "ldl_factor_batched": 9,
                       "ldl_solve_batched": 10}
# the function of kkt/ldl.py that names each wide kernel's form
FORM_OF = {"ldl_factor": "factor_form", "ldl_factor_batched": "factor_form",
           "ldl_solve": "solve_form", "ldl_solve_batched": "solve_form",
           "ldl_solve_refine": "refine_form"}
# the wide forms' shapes: the portfolio SOCP at nass = 64 (n = 65,
# m = 83, N = 148) at B = 4096 and 1, and at nass = 128 (n = 129,
# m = 163, N = 292) at B = 256; the forms its batch launches
WIDE_SHAPES = (((65, 83), 4096), ((65, 83), 1), ((129, 163), 256))
WIDE_FORMS = F64_FORMS + (("ldl_factor_batched", 1),
                          ("ldl_solve_batched", 1))
OCCUPANCY_F32 = {"ldl_factor_batched": "cc_occupancy_f32",
                 "ldl_solve_batched": "cc_occupancy_f32_solve"}


def card_line(query="name,power.limit"):
    """nvidia-smi's answer to `query` for the first card, as one line."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_kkt(rng, B, n, m, spread=4.0):
    """Quasidefinite KKT matrices with the blocks of the reference's
    bench (bench.py:299-314): P = G G' shared, A random per problem, Hs
    spread 10^(+-spread).  They are laid out in the stability order in
    which the dense backend hands K to the factor (kkt/dense.py: the
    inequality rows before the x block), [[-Hs, A], [A', P]]: in the
    bench's x-first order some of these draws lose 1e-8 of accuracy to
    pivot growth in any pivot-free LDL^T, kernel and plain version
    alike.  Returns K (B, N, N) and reg (B, N), numpy."""
    N = n + m
    A = rng.standard_normal((B, m, n))
    K = np.zeros((B, N, N))
    G = rng.standard_normal((n, n)) / np.sqrt(n)
    Hs = 10.0 ** rng.uniform(-spread, spread, (B, m))
    K[:, :m, :m] = -Hs[:, :, None] * np.eye(m)
    K[:, :m, m:] = A
    K[:, m:, :m] = np.transpose(A, (0, 2, 1))
    K[:, m:, m:] = G @ G.T
    dsigns = np.concatenate([-np.ones(m), np.ones(n)])
    return K, np.broadcast_to(dsigns * 1e-8, (B, N)).copy()


def make_qd_kkt(rng, B, N):
    """Well-conditioned symmetric quasidefinite K = [[P, A'], [A, -H]]
    with P = F F' + 0.1 I and H = diag(U(0.5, 1.5)), as
    tests/test_pallas_ldl.py:14-23 builds them, batched: n = N // 2
    positive and m = N - n negative pivots.  Returns (K, n, m)."""
    n = N // 2
    m = N - n
    F = rng.standard_normal((B, n, n))
    A = rng.standard_normal((B, m, n))
    K = np.zeros((B, N, N))
    K[:, :n, :n] = F @ np.transpose(F, (0, 2, 1)) + 0.1 * np.eye(n)
    K[:, :n, n:] = np.transpose(A, (0, 2, 1))
    K[:, n:, :n] = A
    K[:, n:, n:] = -(rng.random((B, m)) + 0.5)[:, :, None] * np.eye(m)
    return K, n, m


def work(name, B, N, R=1, npass=1):
    """(bytes, operations) the function must move and do: each input
    read once and each output written once, K and L counted as the
    triangles the function needs (K is symmetric, and L is strictly
    lower: no consumer reads the zeros the factor kernels write above
    the diagonal).  f64 operands, f32 for the *_batched functions."""
    f8 = 4 if name.endswith("_batched") else 8
    tri = N * (N + 1) // 2
    stri = N * (N - 1) // 2
    solve_ops = 2 * stri * 2 * R + N * R
    factor_ops = N + sum((N - j - 1) + (N - j - 1) * (N - j)
                         for j in range(N))
    if name == "ldl_factor":
        nbytes = B * f8 * (tri + N + stri + N) + B
        ops = factor_ops
    elif name == "ldl_factor_batched":
        nbytes = B * f8 * (tri + stri + N)
        ops = factor_ops
    elif name == "ldl_solve_batched":
        nbytes = B * f8 * (stri + 3 * N)
        ops = solve_ops
    elif name == "ldl_solve":
        nbytes = B * f8 * (stri + N + 2 * N * R)
        ops = solve_ops
    elif name == "kkt_residual":
        nbytes = B * f8 * (tri + 3 * N * R)
        ops = 2 * N * N * R
    else:
        nbytes = B * f8 * (tri + stri + N + 3 * N * R)
        ops = (1 + npass) * (solve_ops + 2 * N * N * R) + npass * N * R
    return nbytes, B * ops


def bound_ms(nbytes, flops, peak_flops=PEAK_F64_PER_S):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate; and which it is."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def cuda_ms(fn, reps, warmup=2):
    """Mean ms per call from CUDA events around `reps` calls, after
    `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_events(prof, path=None):
    """The device kernels of a finished torch.profiler run, as Chrome
    trace events (name, ts and dur in us).  The trace is kept at `path`
    if given."""
    with tempfile.TemporaryDirectory() as tmp:
        path = path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def launch_events_ms(fn, reps, flush=None):
    """Mean ms of one launch of fn from a pair of CUDA events around each
    of `reps` launches (flush.zero_() before each, outside the pair)."""
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in pairs) / reps


def session_durations(events, name, reps):
    """The device ms of the last `reps` launches of kernel `name` among a
    profiler session's kernel events (by start time), or None where the
    session recorded fewer than half of `reps`."""
    got = sorted((e["ts"], e["dur"]) for e in events if name in e["name"])
    durs = [dur / 1e3 for _, dur in got[-reps:]]
    return durs if len(durs) >= max(reps // 2, 1) else None


def device_ms(fns, reps, flush=None, tries=3, timed_by=None):
    """{key: mean device ms per launch} of the kernel named key[1] that
    fns[key] launches, over `reps` launches each under torch.profiler;
    with `flush` (a device tensor), flush.zero_() runs before each
    launch to push the operands out of the L2.

    The profiler may drop a session's events or deliver another
    session's.  Each session starts with one synchronised launch of each
    kernel; a kernel is timed by the last `reps` launches of its name
    that the session recorded, if it recorded at least half of them, and
    a session that recorded fewer is run again, up to `tries` times.  A
    kernel the profiler still misses is timed by CUDA events around each
    launch (launch_events_ms), and the counts the sessions recorded go
    to stderr.  With `timed_by` (a dict), timed_by[key] is set to
    "profiler" or "events"."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    out, seen = {}, {key: [] for key in fns}
    for _ in range(tries):
        todo = {key: fn for key, fn in fns.items() if key not in out}
        if not todo:
            break
        with torch.profiler.profile(activities=acts) as prof:
            for fn in todo.values():
                fn()
            torch.cuda.synchronize()
            for fn in todo.values():
                for _ in range(reps):
                    if flush is not None:
                        flush.zero_()
                    fn()
            torch.cuda.synchronize()
        events = kernel_events(prof)
        for key in todo:
            seen[key].append(sum(key[1] in e["name"] for e in events))
            durs = session_durations(events, key[1], reps)
            if durs is not None:
                out[key] = sum(durs) / len(durs)
    for key, fn in fns.items():
        if timed_by is not None:
            timed_by[key] = "profiler" if key in out else "events"
        if key not in out:
            print(f"kernel_timing: the profiler recorded {seen[key]} "
                  f"launches of {key[1]} in {tries} sessions of {reps + 1}"
                  f" each; timed by CUDA events instead", file=sys.stderr,
                  flush=True)
            out[key] = launch_events_ms(fn, reps, flush)
    return out


def kernel_name(name, R, N):
    """The profiler's name (a prefix) of the kernel that form (name, R)
    launches at N: its wide form above 128."""
    names = WIDE_KERNEL_NAMES if ldl.wide(N) else KERNEL_NAMES
    return names[name].format(R=R)


def wide_form(name, N, R):
    """The form ("shared" or "streaming") that the launcher of kernel
    form (name, R) picks at N on the card (kkt/ldl.py's factor_form,
    solve_form, refine_form); None for a narrow form and the residual.
    A checkout from before a kernel's shared form has only its
    streaming form."""
    if not ldl.wide(N) or name not in FORM_OF:
        return None
    ask = getattr(ldl, FORM_OF[name], None)
    if ask is None:
        return "streaming"
    if name == "ldl_solve_refine":
        return ask(N, R)
    dtype = torch.float32 if name.endswith("_batched") else torch.float64
    return (ask(N, dtype) if "factor" in name else ask(N, R, dtype))


def occupancy(name, R, N, form=None):
    """(resident blocks, resident warps) per SM of the kernel's launch at
    N (a wide kernel's in `form`, wide_form's choice), from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; None where the kernel
    library does not report it."""
    lib = _build.load()
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    out = (ctypes.addressof(blocks), ctypes.addressof(threads))
    if ldl.wide(N):
        fn = getattr(lib, "cc_occupancy_wide", None)
        kid = (SHARED_OCCUPANCY_ID if form == "shared"
               else WIDE_OCCUPANCY_ID)[name]
        args = (kid, N, R) + out
    elif name in OCCUPANCY_ID:
        fn = getattr(lib, "cc_occupancy", None)
        args = (OCCUPANCY_ID[name], N, R) + out
    else:
        fn = getattr(lib, OCCUPANCY_F32[name], None)
        args = (N,) + out
    if fn is None:
        return None
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"cc_occupancy({name}, r={R}): CUDA error {rc}")
    return blocks.value, blocks.value * threads.value // 32


def ptxas(name, R, N, report, form=None):
    """ptxas' {"registers", "spill_stores", "spill_loads", ...} of the
    instantiation that kernel form (name, R) launches at N (a wide
    kernel's in `form`, wide_form's choice), from a build's
    `_build.ptxas_report`: the device function whose template arguments
    agree with (R, slots) -- (slots) for the factors and the f32
    kernels; above N = 128 the type, then (F) for the factors, (R, S)
    for the substitutions and the refined solve -- as far as it has any
    (an older build's kernel may have fewer); None where the report has
    none."""
    wide = ldl.wide(N)
    func = re.match(r"\w+", kernel_name(name, R, N)).group(0)
    slots = (N + 31) // 32
    one = "factor" in name or name.endswith("_batched")
    if wide:  # <T, F> or <T, R, S>: the type's letter, then ints
        shared = form == "shared"
        if "factor" in name:  # F: 1 for the shared form
            want = [int(shared)]
        else:  # S: the shared form's slots, 0 for the streaming form
            want = [1 if name == "ldl_solve_batched" else R,
                    slots if shared else 0]
        kind = "f" if name.endswith("_batched") else "d"
    else:
        want = [slots] if one else [R, slots]
    tag = f"{len(func)}{func}"
    for mangled, rec in report.items():
        at = mangled.find(tag)
        if at < 0:
            continue
        rest = mangled[at + len(tag):]
        if wide:
            m = re.match(r"I([df])((?:Li-?\d+E)*)E", rest)
            got = [int(v) for v in re.findall(r"Li(-?\d+)E",
                                              m.group(2))] if m else None
            if m and m.group(1) == kind and got == want[:len(got)]:
                return rec
            continue
        m = re.match(r"I((?:Li-?\d+E)+)E", rest)
        got = [int(v) for v in re.findall(r"Li(-?\d+)E", m.group(1))] if m else []
        if got == want[:len(got)]:
            return rec
    return None


def operands(B, seed=1, dev="cuda", nm=MAIN_NM):
    """The kernels' inputs at N = sum(nm) (the main path's 76 by
    default), width B: K, reg,
    the factor L, Dinv, right-hand sides b (B, N) and b2 (B, N, 2), and
    x, x2 = their solutions; Kf = K in f32, its f32 factor Lf, Dinvf,
    and bf = b in f32."""
    n, m = nm
    rng = np.random.default_rng(seed)
    Kn, regn = make_kkt(rng, B, n, m)
    K = torch.tensor(Kn, device=dev)
    reg = torch.tensor(regn, device=dev)
    L, Dinv, _ = ldl.ldl_factor(K, reg)
    b = torch.tensor(rng.standard_normal((B, n + m)), device=dev)
    b2 = torch.tensor(rng.standard_normal((B, n + m, 2)), device=dev)
    Kf = K.float()
    Lf, Dinvf = ldl_f32.ldl_factor_batched(Kf)
    return {"K": K, "reg": reg, "L": L, "Dinv": Dinv, "b": b, "b2": b2,
            "x": ldl.ldl_solve(L, Dinv, b), "x2": ldl.ldl_solve(L, Dinv, b2),
            "Kf": Kf, "Lf": Lf, "Dinvf": Dinvf, "bf": b.float()}


def calls(op):
    """{(name, R): (kernel call, plain call)} on the operands `op`."""
    K, reg, L, Dinv = op["K"], op["reg"], op["L"], op["Dinv"]
    rhs = {1: (op["b"], op["x"]), 2: (op["b2"], op["x2"])}
    Kf, Lf, Dinvf, bf = op["Kf"], op["Lf"], op["Dinvf"], op["bf"]
    out = {("ldl_factor", 1): (lambda: ldl.ldl_factor(K, reg),
                               lambda: ldl.ldl_factor_plain(K, reg)),
           ("ldl_factor_batched", 1): (
               lambda: ldl_f32.ldl_factor_batched(Kf),
               lambda: ldl_f32.ldl_factor_batched_plain(Kf)),
           ("ldl_solve_batched", 1): (
               lambda: ldl_f32.ldl_solve_batched(Lf, Dinvf, bf),
               lambda: ldl_f32.ldl_solve_batched_plain(Lf, Dinvf, bf))}
    for R, (b, x) in rhs.items():
        out[("ldl_solve", R)] = (lambda b=b: ldl.ldl_solve(L, Dinv, b),
                                 lambda b=b: ldl.ldl_solve_plain(L, Dinv, b))
        out[("kkt_residual", R)] = (
            lambda b=b, x=x: ldl.kkt_residual(K, x, b),
            lambda b=b, x=x: ldl.kkt_residual_plain(K, x, b))
        out[("ldl_solve_refine", R)] = (
            lambda b=b: ldl.ldl_solve_refine(K, L, Dinv, b, 1),
            lambda b=b: ldl.ldl_solve_refine_plain(K, L, Dinv, b, 1))
    return out


def time_width(B, forms=FORMS, reps=20, plain_reps=3, cold=False,
               nm=MAIN_NM):
    """One row per kernel form of `forms` at (N = sum(nm), B): its device
    ms (and, with `cold`, cold_ms with the L2 flushed), events_ms at
    EVENTS_WIDTH, plain_ms, bound, ptxas' registers and spills, and
    occupancy.  Returns (rows, operands)."""
    op = operands(B, nm=nm)
    N = op["b"].shape[1]
    fns = calls(op)
    report = _build.ptxas_report(_build.build()["log"])
    keyed = {(form, kernel_name(form[0], form[1], N)): fns[form][0]
             for form in forms}
    how = {}
    warm = device_ms(keyed, reps, timed_by=how)
    if cold:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        flushed = device_ms(keyed, reps, flush)
        del flush
    rows = []
    for (form, kname), kern in keyed.items():
        name, R = form
        nbytes, ops = work(name, B, N, R=R)
        bms, by = bound_ms(nbytes, ops, PEAK_F32_PER_S
                           if name.endswith("_batched") else PEAK_F64_PER_S)
        rform = wide_form(name, N, R)
        occ = occupancy(name, R, N, rform)
        reg = ptxas(name, R, N, report, rform) or {}
        row = {"name": name, "R": R, "N": N, "B": B,
               "ms": warm[(form, kname)], "timed_by": how[(form, kname)]}
        if rform is not None:
            row["form"] = rform
        if B == EVENTS_WIDTH:
            row["events_ms"] = cuda_ms(kern, reps)
        if cold:
            row["cold_ms"] = flushed[(form, kname)]
        row.update({
            "plain_ms": cuda_ms(fns[form][1], plain_reps),
            "bound_ms": bms, "bound_by": by,
            "gb": nbytes / 1e9, "gflop": ops / 1e9,
            "blocks_per_sm": occ[0] if occ else None,
            "warps_per_sm": occ[1] if occ else None,
            "registers": reg.get("registers"),
            "spill_bytes": (reg["spill_stores"] + reg["spill_loads"]
                            if "spill_stores" in reg else None)})
        rows.append(row)
    return rows, op


# the library calls' shapes (python3 -m cuclarabel_torch.kernel_timing
# --wide-library): the portfolio at nass = 64 at B = 4096 and 1
WIDE_LIBRARY_SHAPES = (((65, 83), 4096), ((65, 83), 1))
LIBRARY_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def _first_call_ms(fn, reps=20, slow_ms=100.0):
    """(ms, result) of fn: its first call timed by CUDA events, and timed
    again over `reps` calls where it took less than `slow_ms` (cuSOLVER's
    batched LDL^T through torch.linalg loops over the batch on the host,
    so its first call is its time)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1)
    return (ms if ms >= slow_ms else cuda_ms(fn, reps)), out


def library_wide(B, nm):
    """{(name, R): ms} of one PyTorch call computing the function of each
    wide form that has one, at (N = sum(nm), B): cuSOLVER's LDL^T through
    torch.linalg for the factor (Bunch-Kaufman pivoted, of K + diag(reg))
    and the substitution (the port's factor with identity pivots), f64
    and, on a well-conditioned K of the same shape, f32; torch.baddbmm for
    the residual.  Each call's x is held against the kernel's (raises
    beyond LIBRARY_TOL)."""
    op = operands(B, nm=nm)
    N = op["b"].shape[1]
    K, reg, L, Dinv = op["K"], op["reg"], op["L"], op["Dinv"]
    b1 = op["b"][:, :, None]

    def compact(L, Dinv):
        LD = torch.tril(L, -1) + torch.diag_embed(1.0 / Dinv)
        piv = torch.arange(1, N + 1, dtype=torch.int32, device=L.device)
        return LD, piv.expand(Dinv.shape[0], N).contiguous()

    def held(name, got, want):
        e = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1.0)
        if not e < LIBRARY_TOL[want.dtype]:
            raise RuntimeError(f"library call for {name} at N={N} B={B}: "
                               f"x {e:.2e} from the kernel's")

    out = {}
    Kreg = K + torch.diag_embed(reg)
    out[("ldl_factor", 1)], fac = _first_call_ms(
        lambda: torch.linalg.ldl_factor(Kreg))
    held("ldl_factor", torch.linalg.ldl_solve(*fac, b1)[..., 0], op["x"])
    LD, piv = compact(L, Dinv)
    for R, (rhs, x) in {1: (b1, op["x"][:, :, None]),
                        2: (op["b2"], op["x2"])}.items():
        out[("ldl_solve", R)], y = _first_call_ms(
            lambda rhs=rhs: torch.linalg.ldl_solve(LD, piv, rhs))
        held(f"ldl_solve r={R}", y, x)
        xr = x.contiguous()
        out[("kkt_residual", R)], r = _first_call_ms(
            lambda rhs=rhs, xr=xr: torch.baddbmm(rhs, K, xr, alpha=-1))
        held(f"kkt_residual r={R}", r, ldl.kkt_residual_plain(K, xr, rhs))
    Kq, _, _ = make_qd_kkt(np.random.default_rng(15), B, N)
    Kf = torch.tensor(Kq, dtype=torch.float32, device=K.device)
    bf = op["bf"][:, :, None]
    Lf, Df = ldl_f32.ldl_factor_batched(Kf)
    xf = ldl_f32.ldl_solve_batched(Lf, Df, op["bf"])
    out[("ldl_factor_batched", 1)], fac = _first_call_ms(
        lambda: torch.linalg.ldl_factor(Kf))
    held("ldl_factor_batched", torch.linalg.ldl_solve(*fac, bf)[..., 0], xf)
    LDf, pivf = compact(Lf, Df)
    out[("ldl_solve_batched", 1)], y = _first_call_ms(
        lambda: torch.linalg.ldl_solve(LDf, pivf, bf))
    held("ldl_solve_batched", y[..., 0], xf)
    return out


def row_line(card, row):
    occ = ("occupancy not reported" if row["blocks_per_sm"] is None else
           f"{row['blocks_per_sm']} blocks / {row['warps_per_sm']} warps "
           "per SM")
    extra = "".join(f", {label} {row[key]:.4f} ms" for key, label in (
        ("cold_ms", "L2 flushed"), ("events_ms", "by events"))
        if key in row)
    if row.get("registers") is not None:
        occ += (f", ptxas {row['registers']} registers, "
                f"{row['spill_bytes']} B spilled")
    wide = (f" (wide, {row['form']})" if "form" in row else
            " (wide)" if ldl.wide(row["N"]) else "")
    return (f"[{card}] {row['name']}{wide} r={row['R']} at N={row['N']} "
            f"B={row['B']}: device {row['ms']:.4f} ms (L2 warm"
            f"{', CUDA events' if row.get('timed_by') == 'events' else ''})"
            f"{extra}, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
            f"{row['gb']:.4f} GB, {row['gflop']:.4f} GFLOP), plain "
            f"{row['plain_ms']:.3f} ms, {occ}")


def main(argv=()):
    if not torch.cuda.is_available():
        print("cuclarabel_torch.kernel_timing: no CUDA device",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    if list(argv) == ["--wide-library"]:
        for nm, B in WIDE_LIBRARY_SHAPES:
            for (name, R), ms in library_wide(B, nm).items():
                print(json.dumps({"library": name, "R": R, "N": sum(nm),
                                  "B": B, "ms": ms, "card": card}),
                      flush=True)
        return 0
    wide_only = list(argv) == ["--wide"]
    for B in () if wide_only else WIDTHS:
        for row in time_width(B, cold=True)[0]:
            print(row_line(card, row), flush=True)
    for B in () if wide_only else NONSYM_WIDTHS:
        for row in time_width(B, NONSYM_FORMS, cold=True, nm=NONSYM_NM)[0]:
            print(row_line(card, row), flush=True)
    for nm, B in () if wide_only else PSD_SHAPES:
        for row in time_width(B, PSD_FORMS, cold=True, nm=nm)[0]:
            print(row_line(card, row), flush=True)
    for nm, B in WIDE_SHAPES:
        for row in time_width(B, WIDE_FORMS, cold=True, nm=nm)[0]:
            print(row_line(card, row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
