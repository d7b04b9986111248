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
reported, `"compare": false`, since that batch is not bitwise
reproducible from run to run, and `solver_wide_n148`).
The module needs nothing of `cuclarabel_torch` that an earlier version
lacks: a copy placed in another checkout's package digests that
checkout's solves, so that two versions can be compared in one run; a
version without the nonsymmetric or the PSD cones or the sparse paths
reports those paths as skipped.  Needs a CUDA device.
"""

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
# across versions): at nass = 64 the batch is not bitwise reproducible
# from run to run on the card, under "lu" as under "pallas" (ROADMAP F14),
# so its digest is reported and the Solver's compared
WIDE_PATHS = (("batch_wide_n148_B256", _wide_batch, False),
              ("solver_wide_n148", _wide_solver, True))


def digest(sols):
    """{"sha256", "iterations", "statuses"} of a list of solutions."""
    h = hashlib.sha256()
    for s in sols:
        for v in (s.x, s.s, s.z):
            h.update(np.ascontiguousarray(v, dtype=np.float64).tobytes())
    return {"sha256": h.hexdigest(),
            "iterations": [int(s.iterations) for s in sols],
            "statuses": sorted({s.status.name for s in sols})}


def main():
    if not torch.cuda.is_available():
        print("cuclarabel_torch.solve_digest: no CUDA device",
              file=sys.stderr)
        return 1
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
    sys.exit(main())
