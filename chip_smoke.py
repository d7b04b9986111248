#!/usr/bin/env python3
"""Smoke run of cuclarabel_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the torch and CUDA versions;
2. build: compiles csrc/ldl.cu with nvcc into build/ and prints the
   seconds taken;
3. kernels: each of the four LDL^T kernels against its plain PyTorch
   version on the card, at (N, B) = (76, 4096), (13, 1024) and
   (128, 1024), for one and two right-hand sides, plus numpy f64 solves
   of a few problems;
4. main path: cuclarabel_torch.BatchSolver on the portfolio SOCP with
   nass = 32 (KKT dimension 76) at B = 256 and B = 4096: every problem
   SOLVED, the first 8 problems agreeing with the port's CPU solve, and
   the launch counters, set to 0 before each width's solve and read
   after it, showing the kernels ran and no plain version did;
5. timing: warm problems/s, iterations and refinement passes, and each
   kernel's time at (76, 4096) beside its bound, its plain version's
   time and, where one PyTorch call computes the same function, that
   call's time.

The line before the last is the `kernels` JSON, whose `launches` sums
both widths' solves and `launches_per_width` splits them; the last line
is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth and the f64 rate outside
# the tensor cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 34e12

# the portfolio SOCP of the main path
NASS = 32
MAIN_WIDTHS = (256, 4096)
CPU_CHECK = 8
KERNEL_SHAPES = ((33, 43, 4096), (5, 8, 1024), (56, 72, 1024))  # (n, m, B)
NUMPY_CHECK = 4

# accuracy bars (tests/test_pallas_dd.py of the reference)
TOL_FACTOR = 1e-10    # L and D^-1 vs plain, relative to the max entry
TOL_SOLVE = 1e-9      # x vs numpy f64 / plain, relative to max(|x|, 1)
TOL_RESID = 1e-10     # residual vs plain, relative to max(|r|, 1)
TOL_RETURNED_R = 1e-11  # refine's r vs b - K x recomputed, absolute
TOL_OBJ = 1e-7        # objective vs the CPU solve, relative

REPLACES = {
    "ldl_factor": "cuclarabel_tpu/kkt/pallas_dd.py:1318",
    "ldl_solve": "cuclarabel_tpu/kkt/pallas_dd.py:1346",
    "kkt_residual": "cuclarabel_tpu/kkt/pallas_dd.py:1370",
    "ldl_solve_refine": "cuclarabel_tpu/kkt/pallas_dd.py:1395",
}
ALSO_REPLACES = {
    "ldl_solve": "cuclarabel_tpu/kkt/pallas_dd.py:1430",
    "ldl_solve_refine": "cuclarabel_tpu/kkt/pallas_dd.py:1455",
}
SOURCE = "cuclarabel_torch/csrc/ldl.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
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
    alike."""
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


def rel(a, b, floor=0.0):
    a = a.double()
    b = b.double()
    scale = max(float(b.abs().max()), floor)
    return float((a - b).abs().max()) / scale if scale > 0 else 0.0


def cuda_ms(fn, reps):
    """Mean device ms per call from CUDA events around `reps` calls,
    after two warm-up calls."""
    for _ in range(2):
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


def bound_ms(nbytes, flops):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_F64_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def work(name, B, N, R=1, npass=1):
    """(bytes, f64 operations) the function must move and do: each
    input read once and each output written once, K and L counted as
    the triangles the function needs (K is symmetric, and L is strictly
    lower: no consumer reads the zeros the factor kernel writes above
    its diagonal)."""
    f8 = 8
    tri = N * (N + 1) // 2
    stri = N * (N - 1) // 2
    solve_ops = 2 * stri * 2 * R + N * R
    if name == "ldl_factor":
        nbytes = B * f8 * (tri + N + stri + N) + B
        ops = N + sum((N - j - 1) + (N - j - 1) * (N - j) for j in range(N))
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


# ---------------------------------------------------------------------
def phase_build():
    from cuclarabel_torch.kkt import _build

    info = _build.build()
    _build.load()
    print(f"build: {info['seconds']:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {line.strip()}")
    return info


def phase_kernels():
    """Each kernel against its plain version on the card.  Returns the
    max abs error per kernel over all shapes."""
    from cuclarabel_torch.kkt import ldl

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    errs = {k: 0.0 for k in REPLACES}
    for n, m, B in KERNEL_SHAPES:
        N = n + m
        Kn, regn = make_kkt(rng, B, n, m)
        K = torch.tensor(Kn, device=dev)
        reg = torch.tensor(regn, device=dev)
        tag = f"N={N} B={B}"

        L, Dinv, ok = ldl.ldl_factor(K, reg)
        torch.cuda.synchronize()
        Lp, Dinvp, okp = ldl.ldl_factor_plain(K, reg)
        eL, eD = rel(L, Lp), rel(Dinv, Dinvp)
        worst = {"ldl_factor": max(eL, eD)}
        check(bool(ok.all()) and bool(okp.all()), f"factor not ok at {tag}")
        check(eL < TOL_FACTOR and eD < TOL_FACTOR,
              f"ldl_factor vs plain at {tag}: L {eL:.2e}, Dinv {eD:.2e}")
        check(bool((L.triu() == 0).all()), f"L not strictly lower at {tag}")
        errs["ldl_factor"] = max(errs["ldl_factor"],
                                 float((L - Lp).abs().max()),
                                 float((Dinv - Dinvp).abs().max()))

        # refinement runs against the unregularised K: its iterates move
        # from the solution of K + diag(reg) towards that of K
        Kc = Kn[:NUMPY_CHECK]
        Kreg = Kc + np.einsum("bi,ij->bij", regn[:NUMPY_CHECK], np.eye(N))
        for R in (1, 2):
            shape = (B, N) if R == 1 else (B, N, R)
            b = torch.tensor(rng.standard_normal(shape), device=dev)
            x0 = torch.tensor(rng.standard_normal(shape), device=dev)
            bref = b.cpu().numpy()[:NUMPY_CHECK].reshape(NUMPY_CHECK, N, R)
            xref, xref_unreg = (
                torch.tensor(np.linalg.solve(M, bref)).reshape(
                    (NUMPY_CHECK,) + shape[1:]) for M in (Kreg, Kc))

            x = ldl.ldl_solve(L, Dinv, b)
            torch.cuda.synchronize()
            xp = ldl.ldl_solve_plain(L, Dinv, b)
            e1 = rel(x, xp, 1.0)
            e2 = rel(x[:NUMPY_CHECK].cpu(), xref, 1.0)
            check(e1 < TOL_SOLVE and e2 < TOL_SOLVE,
                  f"ldl_solve r={R} at {tag}: vs plain {e1:.2e}, "
                  f"vs numpy {e2:.2e}")
            worst["ldl_solve"] = max(worst.get("ldl_solve", 0.0), e1)
            errs["ldl_solve"] = max(errs["ldl_solve"],
                                    float((x - xp).abs().max()))

            r = ldl.kkt_residual(K, x0, b)
            torch.cuda.synchronize()
            rp = ldl.kkt_residual_plain(K, x0, b)
            e = rel(r, rp, 1.0)
            check(e < TOL_RESID, f"kkt_residual r={R} at {tag}: {e:.2e}")
            worst["kkt_residual"] = max(worst.get("kkt_residual", 0.0), e)
            errs["kkt_residual"] = max(errs["kkt_residual"],
                                       float((r - rp).abs().max()))

            for npass in (0, 1, 2):
                xr, rr = ldl.ldl_solve_refine(K, L, Dinv, b, npass)
                torch.cuda.synchronize()
                xrp, rrp = ldl.ldl_solve_refine_plain(K, L, Dinv, b, npass)
                rtrue = ldl.kkt_residual_plain(K, xr, b)
                e1 = rel(xr, xrp, 1.0)
                e2 = rel(xr[:NUMPY_CHECK].cpu(),
                         xref if npass == 0 else xref_unreg, 1.0)
                e3 = float((rr - rtrue).abs().max())
                check(e1 < TOL_SOLVE and e2 < TOL_SOLVE
                      and e3 < TOL_RETURNED_R,
                      f"ldl_solve_refine r={R} npass={npass} at {tag}: "
                      f"vs plain {e1:.2e}, vs numpy {e2:.2e}, "
                      f"returned r {e3:.2e}")
                worst["ldl_solve_refine"] = max(
                    worst.get("ldl_solve_refine", 0.0), e1)
                errs["ldl_solve_refine"] = max(
                    errs["ldl_solve_refine"], float((xr - xrp).abs().max()))
        print(f"kernels ok at {tag}: max error vs plain "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return errs


def phase_main(card):
    import cuclarabel_torch as ct
    from cuclarabel_torch.kkt import ldl
    from cuclarabel_torch.problems import portfolio_socp

    runs = {}
    per_kernel = {k: {} for k in REPLACES}
    for B in MAIN_WIDTHS:
        A, qs, bs, cones = portfolio_socp(NASS, B, seed=7)
        ldl.reset_counts()
        t0 = time.perf_counter()
        solver = ct.BatchSolver(None, qs, A, bs, cones)
        sols = solver.solve()
        cold = time.perf_counter() - t0
        check(solver.device.type == "cuda", "BatchSolver did not run on CUDA")
        status = [s.status for s in sols]
        check(all(s == ct.SolverStatus.SOLVED for s in status),
              f"B={B}: not all SOLVED: "
              f"{sorted(set(s.name for s in status))}")
        for s in sols:
            check(s.x.shape == (qs.shape[1],) and np.isfinite(s.x).all()
                  and np.isfinite(s.obj_val), f"B={B}: non-finite result")
        launches = dict(ldl.LAUNCHES)
        plain = dict(ldl.PLAIN_CALLS)
        runs[B] = (A, qs, bs, cones, solver, sols, cold)
        print(f"B={B} launches: {json.dumps(launches, sort_keys=True)}")
        print(f"B={B} plain calls: {json.dumps(plain, sort_keys=True)}")
        check(not plain, f"B={B}: plain versions ran on the main path: "
              f"{plain}")
        for key in ("ldl_factor/r1", "ldl_solve_refine/r1",
                    "ldl_solve_refine/r2"):
            check(launches.get(key, 0) > 0, f"B={B}: {key} never launched")
        for k in REPLACES:
            per_kernel[k][f"B{B}"] = sum(
                v for kk, v in launches.items() if kk.split("/")[0] == k)
    for k, v in per_kernel.items():
        check(sum(v.values()) > 0, f"kernel {k} never launched on the "
              "main path")

    # the first problems against the port's CPU solve (plain versions)
    A, qs, bs, cones, _, sols, _ = runs[MAIN_WIDTHS[0]]
    cpu = ct.BatchSolver(None, qs[:CPU_CHECK], A, bs[:CPU_CHECK], cones,
                         device="cpu").solve()
    worst = 0.0
    for g, c in zip(sols[:CPU_CHECK], cpu):
        check(g.status == c.status, f"status {g.status} vs CPU {c.status}")
        worst = max(worst, abs(g.obj_val - c.obj_val) / abs(c.obj_val))
    check(worst <= TOL_OBJ, f"objective vs CPU: {worst:.2e} relative")
    print(f"[{card}] first {CPU_CHECK} problems match the CPU solve: "
          f"max objective difference {worst:.3e} relative")
    return runs, per_kernel


def phase_timing(card, runs):
    for B, (A, qs, bs, cones, solver, sols, cold) in runs.items():
        reps = 3 if B <= 256 else 2
        ts = []
        for r in range(reps):
            solver.update_data(q=qs * (1.0 + 1e-9 * (r + 1)))
            t0 = time.perf_counter()
            solver.solve()
            ts.append(time.perf_counter() - t0)
        it = solver.raw["iterations"]
        ir = solver.raw["ir_count"]
        warm = float(np.median(ts))
        print(f"[{card}] B={B}: warm {B / warm:.1f} problems/s "
              f"(median of {reps}: {warm * 1e3:.1f} ms; first solve "
              f"{cold:.2f} s), IPM iterations mean {it.mean():.2f} max "
              f"{it.max()}, {it.sum() / warm:.0f} problem-iterations/s, "
              f"refinement passes per iteration {ir.sum() / it.sum():.3f}")


def phase_kernel_timing(card):
    from cuclarabel_torch.kkt import ldl

    dev = torch.device("cuda")
    n, m, B = KERNEL_SHAPES[0]
    N = n + m
    rng = np.random.default_rng(1)
    Kn, regn = make_kkt(rng, B, n, m)
    K = torch.tensor(Kn, device=dev)
    reg = torch.tensor(regn, device=dev)
    L, Dinv, _ = ldl.ldl_factor(K, reg)
    b = torch.tensor(rng.standard_normal((B, N)), device=dev)
    x = ldl.ldl_solve(L, Dinv, b)
    b3, x3 = b[:, :, None], x[:, :, None].contiguous()
    calls = {
        "ldl_factor": (lambda: ldl.ldl_factor(K, reg),
                       lambda: ldl.ldl_factor_plain(K, reg), None),
        "ldl_solve": (lambda: ldl.ldl_solve(L, Dinv, b),
                      lambda: ldl.ldl_solve_plain(L, Dinv, b), None),
        "kkt_residual": (lambda: ldl.kkt_residual(K, x, b),
                         lambda: ldl.kkt_residual_plain(K, x, b),
                         lambda: torch.baddbmm(b3, K, x3, alpha=-1)),
        "ldl_solve_refine": (
            lambda: ldl.ldl_solve_refine(K, L, Dinv, b, 1),
            lambda: ldl.ldl_solve_refine_plain(K, L, Dinv, b, 1), None),
    }
    out = {}
    for name, (kern, plain, lib) in calls.items():
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        lib_ms = cuda_ms(lib, 20) if lib is not None else None
        nbytes, ops = work(name, B, N)
        bms, by = bound_ms(nbytes, ops)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bms, "bound_by": by}
        print(f"[{card}] {name} at N={N} B={B}: {ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e9:.3f} GB, "
              f"{ops / 1e9:.3f} GFLOP), plain {plain_ms:.3f} ms, library "
              + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none"))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.device_count()} device(s)")
    phase_build()
    errs = phase_kernels()
    runs, per_kernel = phase_main(card)
    phase_timing(card, runs)
    times = phase_kernel_timing(card)
    kernels = []
    for name in REPLACES:
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[name]}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        entry.update(launches=sum(per_kernel[name].values()),
                     launches_per_width=per_kernel[name],
                     max_abs_err=errs[name], **times[name])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
