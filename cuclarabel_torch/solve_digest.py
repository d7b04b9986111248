"""Digests of the main paths' results on one card, to show that two
versions of the code leave the solves unchanged to the bit.

    python3 -m cuclarabel_torch.solve_digest

Runs the main paths of `chip_smoke.py` -- BatchSolver on the portfolio
SOCP (nass = 32, seed 7) at B = 256 and 4096 with default settings, the
same at B = 4096 with batch_compaction=0.0 (the plain loop:
`batch_B4096_plain`), and Solver on that problem's first instance
(N = 76, the f64 kernels at B = 1) -- and prints one JSON line per path:
the SHA-256 of the solutions' x, s and z (float64 bytes, problem after
problem), the IPM iterations and the statuses.  Equal digests from two
versions mean bitwise-equal solutions.  Default settings compact the
B = 4096 batch since staged compaction was ported, where earlier
versions did not, so that path's digest is reported (`"compare":
false`) and `batch_B4096_plain` is the one to compare.  Then the nonsymmetric
paths: BatchSolver on `problems.exp_logistic(4, 10, B, 5)` (N = 104) at
B = 4096 (staged by default) and 256 (`batch_exp_B4096`,
`batch_exp_B256`), on `problems.genpow_family(8, 256, 9)` (N = 56,
`batch_genpow_B256`), and Solver on exp_logistic's problem 0
(`solver_exp_n104`).  Then the PSD paths: BatchSolver on
`problems.maxcut_sdp(12, B, 11)` (N = 90) at B = 4096 with
batch_compaction=0.0 and at B = 256 (`batch_maxcut_B4096_plain`,
`batch_maxcut_B256`), and Solver on `problems.sdp_chordal_banded(11, 2,
6)` after its chordal decomposition (N = 127, `solver_chordal_n127`).
Then the sparse paths: SparseSolver on `problems.grid_qp(24)` (N_kkt =
1,728, `sparse_solver_grid24`), BatchSparseSolver on
`problems.grid_qp_family(8, 5, 3)` (`batch_sparse_k8_B5`), and Solver
with direct_solve_method="qdldl" on the SOCP golden
(`solver_qdldl_socp`).  Then ShardedSolver on one card on
`problems.box_budget_qp(512, 16384, 0)` (`sharded_qp_n1`) and the
modeling layer's Model of the portfolio's problem 0
(`problems.portfolio_model(32)`, `model_portfolio`).  Then the "pallas"
path above N = 128 (the kernels' wide forms): BatchSolver on the
portfolio at nass = 64 (N = 148) at B = 256 and the Solver on its first
instance, both with kkt_solve_method="pallas" (`batch_wide_n148_B256`,
compared since the fixed-order segment sums of ROADMAP F14, and
`solver_wide_n148`).

    python3 -m cuclarabel_torch.solve_digest --repeat 3 [--method lu]
        [--trace] [--path batch_wide_n148_B256]

solves one path (a name of REPEAT_PATHS) that many times in this process
and prints one digest line per solve, and a line saying whether they
agree; with --trace, every aten operation of each solve is recorded with
an order-free hash of its floating outputs on the device (OpTrace), and
the first operations whose outputs differ between solves are printed:
where all inputs agreed, those are the ones that do not repeat.
The module needs nothing of `cuclarabel_torch` that an earlier version
lacks: a copy placed in another checkout's package digests that
checkout's solves, so that two versions can be compared in one run; a
version without the nonsymmetric or the PSD cones or the sparse paths
reports those paths as skipped.  Needs a CUDA device.
"""

import contextlib
import hashlib
import json
import sys

import numpy as np
import torch

NASS = 32
# (path, B, BatchSolver settings, compared across versions)
BATCH_PATHS = (("batch_B256", 256, {}, True),
               ("batch_B4096", 4096, {}, False),
               ("batch_B4096_plain", 4096, {"batch_compaction": 0.0}, True))
# (path, problems module -> BatchSolver arguments, Solver on problem 0)
NONSYM_PATHS = (
    ("batch_exp_B4096", lambda pr: pr.exp_logistic(4, 10, 4096, 5), False),
    ("batch_exp_B256", lambda pr: pr.exp_logistic(4, 10, 256, 5), False),
    ("batch_genpow_B256", lambda pr: pr.genpow_family(8, 256, 9)[:5],
     False),
    ("solver_exp_n104", lambda pr: pr.exp_logistic(4, 10, 1, 5), True),
)
# (path, (cuclarabel_torch, its problems module) -> solutions)
PSD_PATHS = (
    ("batch_maxcut_B4096_plain", lambda ct, pr: ct.BatchSolver(
        *pr.maxcut_sdp(12, 4096, 11)[:5], batch_compaction=0.0).solve()),
    ("batch_maxcut_B256", lambda ct, pr: ct.BatchSolver(
        *pr.maxcut_sdp(12, 256, 11)[:5]).solve()),
    ("solver_chordal_n127", lambda ct, pr: [
        ct.Solver(*pr.sdp_chordal_banded(11, 2, 6)).solve()]),
)

# (path, (cuclarabel_torch, its problems module) -> solutions)
SPARSE_PATHS = (
    ("sparse_solver_grid24", lambda ct, pr: [
        ct.SparseSolver(*pr.grid_qp(24)).solve()]),
    ("batch_sparse_k8_B5", lambda ct, pr: ct.BatchSparseSolver(
        *pr.grid_qp_family(8, 5, 3)[:5]).solve()),
    ("solver_qdldl_socp", lambda ct, pr: [
        ct.Solver(*pr.socp_golden(), direct_solve_method="qdldl").solve()]),
)


# (path, (cuclarabel_torch, its problems module) -> solutions)
LAST_PATHS = (
    ("sharded_qp_n1", lambda ct, pr: [ct.ShardedSolver(
        *pr.box_budget_qp(512, 16384, 0)).solve()]),
    ("model_portfolio", lambda ct, pr: [pr.portfolio_model(NASS)[0].solve()]),
)


# the "pallas" path above N = 128, where the kernels' wide forms run: the
# portfolio at nass = 64 (N = 148) at B = 256 and its Solver
WIDE_NASS = 64


def _wide_batch(ct, pr):
    A, qs, bs, cones = pr.portfolio_socp(WIDE_NASS, 256, seed=7)
    return ct.BatchSolver(None, qs, A, bs, cones,
                          kkt_solve_method="pallas").solve()


def _wide_solver(ct, pr):
    A, qs, bs, cones = pr.portfolio_socp(WIDE_NASS, 1, seed=7)
    return [ct.Solver(None, qs[0], A, bs[0], cones,
                      kkt_solve_method="pallas").solve()]


# (path, (cuclarabel_torch, its problems module) -> solutions, compared
# across versions); the batch repeats to the bit since its segment sums
# run in a fixed order (ROADMAP F14)
WIDE_PATHS = (("batch_wide_n148_B256", _wide_batch, True),
              ("solver_wide_n148", _wide_solver, True))

# the paths --repeat takes: (cuclarabel_torch, problems, kkt_solve_method)
# -> solutions
REPEAT_PATHS = {
    "batch_wide_n148_B256": lambda ct, pr, method: ct.BatchSolver(
        None, *_permute(pr.portfolio_socp(WIDE_NASS, 256, seed=7)),
        kkt_solve_method=method).solve(),
    "batch_B256": lambda ct, pr, method: ct.BatchSolver(
        None, *_permute(pr.portfolio_socp(NASS, 256, seed=7)),
        kkt_solve_method=method).solve(),
}


def _permute(data):
    """portfolio_socp's (A, qs, bs, cones) as BatchSolver's (qs, A, bs,
    cones)."""
    A, qs, bs, cones = data
    return qs, A, bs, cones


class OpTrace:
    """Records every aten operation run under it: its name and, for each
    floating output, the int64 sum of the output's bits, computed where
    the output lies (integer sums do not depend on their order).
    Outputs of the empty-allocating operations, whose bits are whatever
    the memory held, are skipped."""

    SKIP = ("aten.empty", "aten.new_empty", "aten.empty_like",
            "aten.empty_strided")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        trace = self
        self.names, self.hashes = [], []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = str(func)
                if not name.startswith(trace.SKIP):
                    outs = out if isinstance(out, (tuple, list)) else (out,)
                    for t in outs:
                        if (isinstance(t, torch.Tensor)
                                and t.is_floating_point() and t.numel()):
                            bits = {8: torch.int64, 4: torch.int32,
                                    2: torch.int16}[t.element_size()]
                            trace.names.append(name)
                            trace.hashes.append(
                                t.detach().contiguous().view(bits).sum(
                                    dtype=torch.int64))
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def values(self):
        return [int(h) for h in self.hashes]  # on whichever device


def first_differences(traces, keep=5):
    """The first `keep` positions where the recorded operations or their
    hashes differ between several traces of one computation:
    [(position, op name, hashes)], the name of each trace's operation
    where they differ."""
    vals = [t.values() for t in traces]
    n = min(len(v) for v in vals)
    out = []
    for i in range(n):
        names = {t.names[i] for t in traces}
        if len({v[i] for v in vals}) > 1 or len(names) > 1:
            name = (traces[0].names[i] if len(names) == 1
                    else [t.names[i] for t in traces])
            out.append((i, name, [v[i] for v in vals]))
            if len(out) == keep:
                break
    return out, [len(v) for v in vals]


def repeat(path, runs, method, trace):
    """Solve `path` `runs` times in this process; print each digest, then
    whether they agree (and, traced, where they first part)."""
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems

    digests, traces = [], []
    if trace:  # the first solve fills the caches (plans, kernel library)
        REPEAT_PATHS[path](ct, problems, method)
    for k in range(runs):
        tr = OpTrace() if trace else None
        with tr or contextlib.nullcontext():
            sols = REPEAT_PATHS[path](ct, problems, method)
        if tr is not None:
            traces.append(tr)
        torch.cuda.synchronize()
        d = digest(sols)
        iters = d.pop("iterations")
        d.update(iterations_sum=sum(iters), iterations_max=max(iters))
        digests.append(d["sha256"])
        print(json.dumps({"path": path, "method": method, "run": k, **d}),
              flush=True)
    line = {"path": path, "method": method, "runs": runs,
            "equal": len(set(digests)) == 1}
    if traces:
        diffs, counts = first_differences(traces)
        line.update(ops_recorded=counts, first_differences=[
            {"position": i, "op": name, "hashes": h} for i, name, h in diffs])
    print(json.dumps(line), flush=True)
    return line["equal"]


def digest(sols):
    """{"sha256", "iterations", "statuses"} of a list of solutions."""
    h = hashlib.sha256()
    for s in sols:
        for v in (s.x, s.s, s.z):
            h.update(np.ascontiguousarray(v, dtype=np.float64).tobytes())
    return {"sha256": h.hexdigest(),
            "iterations": [int(s.iterations) for s in sols],
            "statuses": sorted({s.status.name for s in sols})}


def main(argv=()):
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m "
                                 "cuclarabel_torch.solve_digest")
    ap.add_argument("--repeat", type=int, default=0,
                    help="solve --path this many times in one process")
    ap.add_argument("--path", default="batch_wide_n148_B256",
                    choices=sorted(REPEAT_PATHS))
    ap.add_argument("--method", default="pallas", choices=("pallas", "lu"))
    ap.add_argument("--trace", action="store_true",
                    help="with --repeat: find the first operations whose "
                    "outputs differ between the solves")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cuclarabel_torch.solve_digest: no CUDA device",
              file=sys.stderr)
        return 1
    if args.repeat:
        return 0 if repeat(args.path, args.repeat, args.method,
                           args.trace) else 3
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import portfolio_socp

    for path, B, settings, compare in BATCH_PATHS:
        A, qs, bs, cones = portfolio_socp(NASS, B, seed=7)
        report(path, ct.BatchSolver(None, qs, A, bs, cones,
                                    **settings).solve(), compare)
    A, qs, bs, cones = portfolio_socp(NASS, 1, seed=7)
    report("solver_n76", [ct.Solver(None, qs[0], A, bs[0], cones).solve()])
    from cuclarabel_torch import problems

    for path, make, single in NONSYM_PATHS:
        if not hasattr(problems, "exp_logistic"):
            print(json.dumps({"path": path, "skipped": "not in this "
                              "version"}), flush=True)
            continue
        data = make(problems)
        if single:
            P, qs, A, bs, cones = data
            sols = [ct.Solver(P, qs[0], A[0], bs[0], cones).solve()]
        else:
            sols = ct.BatchSolver(*data).solve()
        report(path, sols)
    for path, make in PSD_PATHS:
        if not hasattr(problems, "maxcut_sdp"):
            print(json.dumps({"path": path, "skipped": "not in this "
                              "version"}), flush=True)
            continue
        report(path, make(ct, problems))
    for path, make in SPARSE_PATHS:
        if not hasattr(ct, "SparseSolver"):
            print(json.dumps({"path": path, "skipped": "not in this "
                              "version"}), flush=True)
            continue
        report(path, make(ct, problems))
    for path, make in LAST_PATHS:
        if not hasattr(ct, "ShardedSolver"):
            print(json.dumps({"path": path, "skipped": "not in this "
                              "version"}), flush=True)
            continue
        report(path, make(ct, problems))
    from cuclarabel_torch.kkt import ldl

    for path, make, compare in WIDE_PATHS:
        if not hasattr(ldl, "NARROW_MAX_N"):
            print(json.dumps({"path": path, "skipped": "not in this "
                              "version"}), flush=True)
            continue
        report(path, make(ct, problems), compare)
    return 0


def report(path, sols, compare=True):
    """Print one path's digest line, the iterations as their sum and
    maximum."""
    d = digest(sols)
    iters = d.pop("iterations")
    d.update(iterations_sum=sum(iters), iterations_max=max(iters))
    print(json.dumps({"path": path, "compare": compare, **d}), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
