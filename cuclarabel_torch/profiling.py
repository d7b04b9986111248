"""Where the time of a cuclarabel_torch solve goes, on one card.

    python3 -m cuclarabel_torch.profiling [--widths 256 4096] [--out DIR]

`phase_breakdown(solver)` (behind `Solver.profile_phases`) times each
IPM phase at a single-problem Solver's exact shapes, the counterpart of
`cuclarabel_tpu/profiling.py`; the rest of the module is the script.

Solves the portfolio SOCP (nass = 32, KKT dimension 76) with
cuclarabel_torch.BatchSolver at each width with default settings, and
again with batch_compaction=0.0 at each width where the default compacts
(B >= 1024), then one such problem with the single-problem
cuclarabel_torch.Solver: one warm-up solve, then one timed solve, then
one solve under torch.profiler (device activity only).  Prints, per run:
the wall time of both, the device busy time (the union of the kernels'
intervals on the timeline), the idle share, the number of kernel
launches and of IPM loop passes (and for a staged solve its compaction
record), and the device time by kernel name, largest first.  With --out
it writes each trace as a Chrome trace JSON there.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .cones import ops as cone_ops
from .kernel_timing import kernel_events
from .kkt.dense import make_dense_kkt
from .kkt import ldl
from .parallel.batch import BatchSolver
from .problems import portfolio_socp
from .settings import Settings
from .solver import Solver


def _phase_seconds(fn, reps, cuda):
    """Mean seconds per call of fn after one warm-up call: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps / 1e3


def phase_breakdown(solver, reps: int = 3):
    """Seconds per call of each IPM phase of `solver` (a Solver) at its
    exact shapes, on its device, from the cone-interior unit iterates
    (reference profiling.py:40-113): scale_cones (the scaling update),
    hs_assembly, kkt_factor, kkt_solve (one refined solve), kkt_solve_pair
    (two against one factor, where the backend pairs them), residuals
    (the rx/rz products) and step_length (one cone search).  Stored in
    solver.timers["device"], which print_timers() reports."""
    layout, st = solver.layout, solver.settings
    n, m = solver.n, solver.m
    dev = solver._dev
    P, A, q, b = dev["P"], dev["A"], dev["q"], dev["b"]
    device = q.device
    cuda = device.type == "cuda"
    factorize, kkt_solve = make_dense_kkt(n, m, st, layout, device)
    z0, s0 = cone_ops.unit_initialization(layout, 1, device)
    mu = torch.ones(1, dtype=torch.float64, device=device)
    flag = torch.zeros(1, dtype=torch.int32, device=device)

    def scale():
        return cone_ops.update_scaling(layout, s0, z0, mu, flag)[0]

    res = {"scale_cones": _phase_seconds(scale, reps, cuda)}
    scal = scale()

    def hs():
        # a layout of zero cones only has no scaling state and Hs = 0
        return (cone_ops.assemble_Hs_dense(layout, scal) if scal
                else b.new_zeros(1, m, m))

    res["hs_assembly"] = _phase_seconds(hs, reps, cuda)
    Hs = hs()
    res["kkt_factor"] = _phase_seconds(lambda: factorize(P, A, Hs), reps,
                                       cuda)
    fac, _ = factorize(P, A, Hs)
    res["kkt_solve"] = _phase_seconds(lambda: kkt_solve(fac, -q, b), reps,
                                      cuda)
    pair = getattr(kkt_solve, "pair", None)
    if pair is not None:
        res["kkt_solve_pair"] = _phase_seconds(
            lambda: pair(fac, -q, b, -2 * q, 2 * b), reps, cuda)

    def residuals():
        rx = torch.bmm(A.transpose(1, 2), b[:, :, None])
        if solver._has_P:
            rx = rx + torch.bmm(P, q[:, :, None])
        return rx, torch.bmm(A, q[:, :, None])

    res["residuals"] = _phase_seconds(residuals, reps, cuda)
    res["step_length"] = _phase_seconds(
        lambda: cone_ops.step_length(layout, scal, -z0, -s0, z0, s0, mu, st),
        reps, cuda)
    solver.timers["device"] = res
    return res


def busy_ms(events):
    """Length of the union of the device intervals, in ms."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, end = 0.0, -1.0
    for a, b in spans:
        if a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def profile(B, out_dir, **settings):
    """BatchSolver at width B."""
    A, q, b, cones = portfolio_socp(32, B, seed=7)
    solver = BatchSolver(None, q, A, b, cones, **settings)
    tag = f"B={B}" + (" plain" if settings else "")
    report(tag, solver.solve, out_dir, lambda: solver.raw["iterations"],
           lambda: getattr(solver, "last_compaction", None))


def profile_solver(out_dir):
    """The single-problem Solver on problem 0 of the same batch."""
    A, q, b, cones = portfolio_socp(32, 1, seed=7)
    solver = Solver(None, q[0], A, b[0], cones)
    report("Solver", solver.solve, out_dir,
           lambda: np.array([solver.get_info()["iterations"]]))


def report(tag, solve, out_dir, iterations, compaction=lambda: None):
    solve()
    t0 = time.perf_counter()
    solve()
    wall_unprofiled = (time.perf_counter() - t0) * 1e3
    ldl.reset_counts()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    name = f"trace_{tag.replace('=', '').replace(' ', '_').lower()}.json"
    kern = kernel_events(prof, os.path.join(out_dir, name) if out_dir
                         else None)
    by_name = {}
    for e in kern:
        k = e["name"][:60]
        n, t = by_name.get(k, (0, 0.0))
        by_name[k] = (n + 1, t + e["dur"] / 1e3)
    busy = busy_ms(kern)
    passes = int(ldl.LAUNCHES["ldl_factor/r1"]) - 1  # minus the init
    its = iterations()
    print(json.dumps({
        "run": tag, "wall_ms_unprofiled": wall_unprofiled,
        "wall_ms": wall, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall, "kernel_launches": len(kern),
        "ipm_loop_passes": passes,
        "launches_per_pass": len(kern) / max(passes, 1),
        "iterations_mean": float(its.mean()), "iterations_max": int(its.max()),
        "ldl_launches": dict(ldl.LAUNCHES), "compaction": compaction(),
    }))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (n, t) in top:
        print(f"  {t:9.3f} ms {t / wall * 100:5.1f}% of wall  {n:6d} x  "
              f"{name}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[256, 4096])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cuclarabel_torch.profiling: no CUDA device", file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for B in args.widths:
        profile(B, args.out)
        if Settings().resolved_batch_compaction(B) > 0.0:
            profile(B, args.out, batch_compaction=0.0)
    profile_solver(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
