"""Where the time of a cuclarabel_torch solve goes, on one card.

    python3 -m cuclarabel_torch.profiling [--widths 256 4096] [--out DIR]

Solves the portfolio SOCP (nass = 32, KKT dimension 76) with
cuclarabel_torch.BatchSolver at each width, then one such problem with
the single-problem cuclarabel_torch.Solver: one warm-up
solve, then one timed solve, then one solve under torch.profiler
(device activity only).  Prints, per run: the wall time of both, the
device busy time (the union of the kernels' intervals on the timeline),
the idle share, the number of kernel launches and of IPM loop passes,
and the device time by kernel name, largest first.  With --out it writes
each trace as a Chrome trace JSON there.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .kernel_timing import kernel_events
from .kkt import ldl
from .parallel.batch import BatchSolver
from .problems import portfolio_socp
from .solver import Solver


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


def profile(B, out_dir):
    """BatchSolver at width B."""
    A, q, b, cones = portfolio_socp(32, B, seed=7)
    solver = BatchSolver(None, q, A, b, cones)
    report(f"B={B}", solver.solve, out_dir,
           lambda: solver.raw["iterations"])


def profile_solver(out_dir):
    """The single-problem Solver on problem 0 of the same batch."""
    A, q, b, cones = portfolio_socp(32, 1, seed=7)
    solver = Solver(None, q[0], A, b[0], cones)
    report("Solver", solver.solve, out_dir,
           lambda: np.array([solver.get_info()["iterations"]]))


def report(tag, solve, out_dir, iterations):
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
    name = f"trace_{tag.replace('=', '').lower()}.json"
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
        "ldl_launches": dict(ldl.LAUNCHES),
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
    profile_solver(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
