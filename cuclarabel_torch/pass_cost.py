"""What one IPM pass of the batch path costs on the card: kernel launches
per pass and warm problems/s of the portfolio SOCP, and the wide refined
solve's and residual's device times.

    python3 -m cuclarabel_torch.pass_cost [--wide-batch] [--wide-kernels]

prints one JSON line per measurement.  The script imports the package by
its absolute name, so that it can measure another checkout of the port
too, in the same process setup and on the same card:

    PYTHONPATH=<checkout> python3 <this file> [--wide-batch] [--wide-kernels]

Batches (`BATCHES`): nass = 32 (N = 76) at B = 256 and 4096 under
"pallas" (B = 256 runs unstaged, so that its launches per pass are those
of one pass of the loop), and nass = 64 (N = 148) at B = 4096 under
"pallas" and "lu".  Each: one cold solve, then WARM_REPS warm solves on
q nudged by 1e-9 relative (so that nothing is reused), their median in
problems/s; then one warm solve under torch.profiler, whose kernel
launches are divided by the solve's passes, the largest IPM iteration
count of the batch (the loop runs until its last problem stops), with
its device busy ms (the union of the kernels' intervals) and the
kernels that take the most device time.  The profiler may drop a
session's events: launches are then not measured.  With --wide-batch,
the nass = 64 batch under "pallas" alone (WIDE_BATCH), and no segment
sums.
Then the host's microseconds per call of the SOC segment sum at the
nass = 32 batch's shape (one cone of 9 entries), by
`cones/segsum.segment_sum` where the checkout has it and by the
`index_add_` it replaced, each over SEG_CALLS calls with the queue
drained at the end.  With --wide-kernels, the device ms of the wide
refined solve and residual at R = 1 and 2 at kernel_timing's
WIDE_SHAPES.
"""

import collections
import json
import re
import sys
import time

import numpy as np
import torch

import cuclarabel_torch as ct
from cuclarabel_torch import kernel_timing as kt
from cuclarabel_torch.problems import portfolio_socp

BATCHES = ((32, 256, "pallas", 0.0), (32, 4096, "pallas", None),
           (64, 4096, "pallas", None), (64, 4096, "lu", None))
WIDE_BATCH = BATCHES[2]  # the one the wide kernels run on (N = 148)
WARM_REPS = 7
TOP_KERNELS = 8
SEG_CALLS = 2000
WIDE_KERNEL_FORMS = (("ldl_solve_refine", 1), ("ldl_solve_refine", 2),
                     ("kkt_residual", 1), ("kkt_residual", 2))


def warm_ms(solver, qs, r):
    solver.update_data(q=qs * (1.0 + 1e-9 * (r + 1)))
    t0 = time.perf_counter()
    solver.solve()
    return (time.perf_counter() - t0) * 1e3


def batch_cost(nass, B, method, quorum):
    A, qs, bs, cones = portfolio_socp(nass, B, seed=7)
    kw = {"kkt_solve_method": method}
    if quorum is not None:
        kw["batch_compaction"] = quorum
    solver = ct.BatchSolver(None, qs, A, bs, cones, **kw)
    t0 = time.perf_counter()
    sols = solver.solve()
    cold = time.perf_counter() - t0
    solved = sum(s.status == ct.SolverStatus.SOLVED for s in sols)
    ms = [warm_ms(solver, qs, r) for r in range(WARM_REPS)]
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        warm_ms(solver, qs, WARM_REPS)
        torch.cuda.synchronize()
    kern = kt.kernel_events(prof)
    passes = int(np.max(solver.raw["iterations"]))
    names = collections.Counter(_name(e) for e in kern)
    dev_ms = collections.Counter()
    for e in kern:
        dev_ms[_name(e)] += e["dur"] / 1e3
    return {"nass": nass, "N": int(A.shape[1] + A.shape[0]), "B": B,
            "method": method, "staged": quorum != 0.0,
            "solved": int(solved), "cold_s": cold,
            "warm_ms": ms, "problems_per_s_median": B * 1e3 / np.median(ms),
            "iterations_sum": int(np.sum(solver.raw["iterations"])),
            "passes": passes,
            "launches": len(kern) or None,
            "launches_per_pass": len(kern) / passes if kern else None,
            "busy_ms": busy_ms(kern) if kern else None,
            "top_kernels": names.most_common(TOP_KERNELS),
            "top_kernels_ms": [(k, v, names[k]) for k, v in
                               dev_ms.most_common(TOP_KERNELS)]}


def _name(event):
    """A kernel's name without its argument list, at most 80 characters."""
    return re.sub(r"\([^()]*\)$", "", event["name"])[:80]


def busy_ms(events):
    """The union of the kernels' intervals, ms."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, end = 0.0, -np.inf
    for t0, t1 in spans:
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total / 1e3


def host_us(fn, calls=SEG_CALLS):
    """Microseconds per call of fn on the host clock, after 10 calls, the
    queue drained before and after."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def seg_sum_host(B):
    seg = np.zeros(9, dtype=np.int64)
    vals = torch.randn(B, 9, dtype=torch.float64, device="cuda")
    ids = torch.as_tensor(seg, device="cuda")
    out = {"B": B, "index_add_host_us": host_us(
        lambda: vals.new_zeros(B, 1).index_add_(1, ids, vals))}
    try:
        from cuclarabel_torch.cones import segsum
    except ImportError:  # a checkout before the kernel
        return out
    segs = segsum.Segments(seg, "cuda")
    out["segment_sum_host_us"] = host_us(
        lambda: segsum.segment_sum(vals, segs))
    return out


def main(argv=()):
    if not torch.cuda.is_available():
        print("pass_cost: no CUDA device", file=sys.stderr)
        return 1
    card = kt.card_line()
    tree = ct.__file__
    wide = "--wide-batch" in argv
    for nass, B, method, quorum in (WIDE_BATCH,) if wide else BATCHES:
        rec = batch_cost(nass, B, method, quorum)
        print(json.dumps(dict(rec, card=card, package=tree)), flush=True)
    for B in () if wide else (256, 4096):
        print(json.dumps(dict(seg_sum_host(B), card=card, package=tree)),
              flush=True)
    if "--wide-kernels" in argv:
        for nm, B in kt.WIDE_SHAPES:
            for row in kt.time_width(B, WIDE_KERNEL_FORMS, nm=nm)[0]:
                print(json.dumps({k: row.get(k) for k in (
                    "name", "R", "N", "B", "ms", "bound_ms", "registers",
                    "spill_bytes", "blocks_per_sm", "form")}
                    | {"card": card, "package": tree}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
