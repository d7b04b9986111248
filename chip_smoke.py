#!/usr/bin/env python3
"""Smoke run of cuclarabel_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the torch and CUDA versions;
2. build: compiles csrc/*.cu with nvcc into build/ (one nvcc per source,
   started together) and prints the seconds taken, and ptxas' registers
   and spill bytes of ldl_factor_kernel and kkt_residual_kernel (a
   spill fails the run);
3. kernels: each of the four f64 LDL^T kernels against its plain
   PyTorch version on the card, at (N, B) = (76, 4096), (13, 1024),
   (128, 1024), the Solver's B = 1 shapes (76, 1), (12, 1), (8, 1), the
   nonsymmetric path's (104, 4096) and (104, 1), and the PSD paths'
   (90, 4096), (73, 256) and (127, 1),
   for one and two right-hand sides (ldl_factor and ldl_solve bit for
   bit), plus numpy f64 solves of a few problems, K carrying junk above
   its diagonal, which no kernel may read; ldl_factor bit for bit at
   (N, B) = (8, 300), (9, 300), (76, 300) and (128, 300) too, around the
   edges of its 8-pivot panels and 4 x 4 tiles; then the two f32 kernels (ldl_factor_batched,
   ldl_solve_batched) against theirs at (N, B) = (16, 5), (76, 4096),
   (128, 256) and (9, 3), with numpy's reconstruction of K and the
   inertia of D; then the probe kernels (csrc/probes.cu) against theirs,
   bit for bit: each P1 variant at (N, B) = (83, 4096) and (13, 256), each
   P2 (R, streams) of its sweep, on seeded random inputs and on the
   reference's constants; then the segment-sum kernel (csrc/segsum.cu)
   against its plain version (index_add_ on the CPU) bit for bit on the
   batch path's second-order cone and rectification segments at B = 256
   and 4096, a problem alone as in its batch, with its device time,
   bound, plain and index_add_ times at B = 4096;
4. main paths, each driven with the launch counters set to 0 just
   before it and read just after, showing its kernels ran and no plain
   version did:
   - batch: cuclarabel_torch.BatchSolver on the portfolio SOCP with
     nass = 32 (KKT dimension 76) at B = 256 and B = 4096 with default
     settings -- B = 4096 compacts (auto batch_compaction 0.9 at
     B >= 1024): its last_compaction, with stage 2 run, and its launches
     split between the stages are printed -- and at B = 4096 with
     batch_compaction=0.0 (batch_B4096_plain): every problem SOLVED; the
     staged path equal to the plain one in status and iterations with
     the objective within 1e-9 relative (the largest |dx|, |ds|, |dz|
     printed, and, where the two are not bitwise equal, the loop
     operations whose per-problem result depends on the batch width);
     the first 8 problems at B = 256 agreeing with the port's CPU solve;
   - batch_B256_warm: update_data(q=1.01 q) at B = 256, then a solve
     warm-started from the previous solutions: every problem SOLVED,
     within 1e-6 of a cold re-solve, in fewer iterations summed;
   - solver: cuclarabel_torch.Solver on the QP, LP and SOCP goldens and
     the portfolio SOCP at nass = 32 (N = 76, "pallas": the f64 kernels
     at B = 1) and nass = 64 (N = 148, "lu"): every problem SOLVED with
     the objective and iteration count of Solver(..., device="cpu");
     then an update_q with a warm-started re-solve, and one verbose
     solve whose table is printed (first, repeat and warm-started solve
     ms of the N = 76 problem); then the same problems under
     kkt_solve_method "qr" and "inverse" (library calls, no kernel):
     SOLVED, the objective within 1e-7 relative of "lu" on the card, the
     CPU's iterations; and profile_phases() of the N = 76 Solver;
   - f32: ldl_factor_batched and ldl_solve_batched at (76, 4096);
   - probes: the sweeps of the probes' entry points,
     cuclarabel_torch.probes.mosaic_probe at (83, 4096) and
     mosaic_probe2 (device time, bound, share of the issue rate, and for
     P2 ptxas' registers and spills), then each plain version's time;
5. timing: each f64 kernel form (R = 1 and 2) at N = 76 and B = 4096,
   256 and 1, K1-K4 (R = 1) at N = 104 and B = 4096 and 1, and K1-K4
   and K2r at the PSD paths' (90, 4096) and (127, 1)
   (cuclarabel_torch.kernel_timing: device time, CUDA events
   at B = 4096, resident blocks and warps per SM, ptxas' registers and
   spill bytes) beside its bound, its
   plain version's time and, where one PyTorch call computes the same
   function, that call's time (cuSOLVER's LDL^T for the factor and
   the substitution, the residual's torch.baddbmm, at every shape but
   (104, 4096) and (90, 4096)); the f32 kernels at (76, 4096), and the
   f64 factor and substitution on the f32 K, by device time.  A kernel's
   `ms` is its device time per launch (torch.profiler, or CUDA events
   around each launch where the profiler dropped its launches:
   `timed_by`); plain and library times are CUDA events around the
   call.  Then warm problems/s, iterations and refinement passes of the
   batch at B = 256, and at B = 4096 staged and plain in turns (5 warm
   solves each: median and spread, and the device busy ms of one
   profiled warm solve of each, not measured where two sessions' traces
   lack launches the LDL^T kernels' counters saw).

6. nonsymmetric paths, last (the profiler's sessions of ~10^5
   launches come after the kernel timing), each driven with the launch
   counters set to 0 just before it and read just after: BatchSolver
   on problems.exp_logistic(4, 10, B, 5) (N = 104) at B = 4096 (staged,
   auto quorum 0.9), at B = 4096 with batch_compaction=0.0 and at
   B = 256: every problem SOLVED or ALMOST_SOLVED, at most 0.5%
   ALMOST_SOLVED (the reference's own rate is 0.3%, ROADMAP F8); the
   staged path and the B = 256 batch bit for bit with the plain B = 4096
   batch, problem by problem (status, iterations, x, s, z); the first
   8 problems against the port's CPU solve: the same status, objectives
   within 1e-7 relative (iterations printed: the CPU's log, exp and sums
   round otherwise, and these problems amplify rounding);
   problems.genpow_family(8, 256, 9) (N = 56): every problem SOLVED
   within 1e-6 relative of its analytic optimum; Solver on the exp, pow
   and genpow goldens and exp_logistic's problem 0: SOLVED with the
   CPU's iterations, objective within 1e-7 of the CPU's and within the
   goldens' 1e-3; then per path the loop passes, kernel launches
   and host syncs per pass (torch.cuda's sync debug mode), iterations,
   the problems that ended under Dual scaling, warm problems/s over 3
   solves (median and spread) and the device busy and idle share of one
   profiled warm solve.

7. PSD paths, after the nonsymmetric ones: torch.linalg's batched
   eigvalsh, eigh, cholesky_ex and svd against numpy f64 at r = 3, 6, 8
   and 12 (B = 4096), within 1e-12 of the matrix's norm; then, each
   driven with the launch counters set to 0 just before it and read
   just after, BatchSolver on problems.maxcut_sdp(12, B, 11) (N = 90) at
   B = 4096 (staged), at B = 4096 with batch_compaction=0.0 and at
   B = 256: every problem SOLVED, its certificate X = mat(z) with
   diag(X) within 1e-7 of 1, lambda_min(X) >= -1e-7 ||X|| and sum(y)
   within 1e-7 relative of <L/4, X>; the staged path against the plain
   one as the portfolio's is; the first 8 against the port's CPU solve
   (statuses, objectives within 1e-7; iterations printed);
   problems.psd_min_eig(8, 256, 3) (N = 73): every problem SOLVED within
   1e-7 of lambda_min(C); Solver on the SDP golden and the mixed
   SDP + SOC problem under "pallas" and "lu", the chordal problem of
   tests/test_sdp_chordal.py under its 12 settings, sdp_chordal_banded
   at nv = 11 (N = 127, "pallas") and 12 (N = 141, "lu") and the nv = 24
   PSD projection under "lu" and "qr": SOLVED with the CPU's iterations
   and objectives within 1e-7 (the reference's iterations printed
   beside the banded rows); then per batch path and the N = 127 Solver
   the record of phase 6.

8. sparse paths, each driven with the LDL^T kernels' counters set
   to 0 just before it and read just after (the sparse paths run none
   of them: the multifrontal LDL^T is plain torch, QDLDL host C++):
   SparseSolver on problems.grid_qp(100) (N_kkt = 30,000): SOLVED with
   r_prim and r_dual < 1e-8, the optimality conditions recomputed in
   numpy f64 on the host within 1e-7 relative, a second solve bitwise
   equal in x, z and iterations, update_data(q=1.01 q) re-solved with
   no new symbolic analysis (the SparseProblem's memo unchanged); the
   AUG2D-class QP of problems.make_grid_qp_qps(100) (n = 19,800,
   m = 9,999) through qps.parse_qps, to_clarabel and SparseSolver, its
   objective within 1e-6 of scipy's spsolve (grid_qp_reference); f32
   fronts at k = 24 (r_prim, r_dual < 1e-8, x within 1e-6 of f64's);
   BatchSparseSolver on problems.grid_qp_family(24, 256, 3) with q and
   b varying, then with the P and A values varying too: every problem
   SOLVED, the first 8 with the statuses and iterations of single
   SparseSolver solves on the card and x within 1e-7, problems/s as the
   median of 3 warm solves with the spread; Solver with
   direct_solve_method="qdldl" on the QP, LP and SOCP goldens and the
   portfolio at nass = 64: SOLVED in "lu"'s iterations; a chordal SDP
   (sdp_chordal_banded(11, 2, 6)) through SparseSolver: SOLVED, the
   objective within 1e-7 of the dense Solver's.  Per row: cold (the
   analysis included) and warm wall ms, iterations, loop passes and
   host syncs per pass, launches per pass, per factorization and per
   refined solve, the device busy and idle share of one profiled solve,
   and the peak device memory beside the plan's estimate.  To keep the
   smoke's time, cuSOLVER's LDL^T is timed at B = 4096 at N = 76 only
   (phase 5), no longer at N = 104 and 90.

9. sharded: ShardedSolver on one card (the block-arrow KKT, which runs
   none of the LDL^T kernels: cuBLAS products and a plain-torch saddle
   inverse) on problems.box_budget_qp(512, 524288, 0) (n = 512,
   m = 524,289, A 2.1 GB in f64), driven with the counters set to 0
   just before it and read just after: SOLVED, the optimality
   conditions recomputed in numpy f64 on the host within 1e-7, a second
   solve bitwise equal; cold (construction included) and warm ms, loop
   passes, host syncs and launches per pass, the idle share of one
   profiled solve, peak memory and the saddle inverses kept
   (kkt/arrow.py's guard); then problems.sharded_socp() with the CPU's
   iterations and objective within 1e-7.
10. multi, with 2 or more cards (with one, a line says it did not run
   and why): the same QP over every card (objective within 1e-8 of one
   card's, each card's peak memory against its slab of A), then
   BatchSolver on the portfolio at B = 4096 over every card, K1-K4
   launched on every card (kkt/ldl.py's LAUNCHES.by_device), each slab
   bitwise equal to a one-card batch of it on its card, and warm
   problems/s at 1, 2, 4 ... cards.  `python3 chip_smoke.py --multi`
   runs the build and phases 9 and 10 alone.
11. modeling: problems.portfolio_model(32) through the modeling layer on
   the card, the dense backend bitwise equal to Solver on the same
   data, the sparse backend (SparseSolver) SOLVED within 1e-7 of it.
12. precompile: precompile() in a fresh process, each family's seconds
   on its first call (the process's one-time costs, the port's
   first-solve latency) and on a second.

13. wide (after the f32 kernel timing, before the profiled batch
   solves of phase 5's timing): the "pallas" path above N = 128, where
   the wrappers launch the kernels' wide forms (csrc/ldl_wide.cu).  Each
   wide form against its plain version at (N, B) = (129, 5),
   (148, 4096), (148, 1), (169, 64), (220, 16), (221, 16), (226, 16),
   (227, 16), (233, 16), (234, 16), (240, 16), (241, 16) (the largest N
   at which each kernel keeps its triangle in shared memory, and the
   next: the factor 220, the refined solve 226 at R = 2 and 233 at
   R = 1, the substitution 240) and (292, 256), in the form each
   launcher picks there, R = 1 and 2,
   npass 0, 1 and 2 (factor and substitution bit for bit, residual and
   refined solve within 1e-12 relative, the refined solve's r bit for bit
   the residual's, 2-RHS bit for bit two 1-RHS, and at (148, 4096) three
   problems alone bit for bit as in the batch), the f32 ones at (129, 5),
   (148, 4096), (256, 5), (257, 5), (292, 256), (320, 5) and (321, 5)
   (the f32 substitution's edge at 256, the factor's at 320); three
   solves of the nass = 64 portfolio
   at B = 256 under "pallas" and under "lu", one digest each (ROADMAP
   F14); then, each driven with the counters set to 0 just
   before it and read just after (wide forms only): BatchSolver on the
   portfolio at nass = 64 (N = 148), B = 4096, kkt_solve_method="pallas",
   staged and plain (every problem SOLVED, staged equal to plain in
   status and iterations, the first 8 within 1e-7 of the CPU), the
   Solver on its problem 0, nass = 128 (N = 292) at B = 256 and the f32
   entry points at (148, 4096); the same batch under "lu", the
   per-problem difference in iterations printed, and warm problems/s of
   both, staged, in turns; the wide forms' device ms at (148, 4096),
   (148, 1) and (292, 256), each with the form it ran in, beside bound,
   plain, library (cuSOLVER's LDL^T at B = 256, baddbmm for the
   residual) and occupancy.  `python3 chip_smoke.py
   --wide` runs the build and this phase alone.

The line before the last is the `kernels` JSON, whose `launches` sums
the main paths' runs and `launches_per_path` splits them, and whose
`by_shape` holds the f64 kernels' times at every timed shape; the last
line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import collections
import json
import sys
import time

import numpy as np
import torch

from cuclarabel_torch import kernel_timing as kt
from cuclarabel_torch.kernel_timing import (card_line, cuda_ms, make_kkt,
                                           make_qd_kkt)

# the portfolio SOCP of the main path
NASS = 32
CPU_CHECK = 8
# (n, m, B): the batch widths, then the Solver's B = 1 at N = 76 and at
# the sizes of the goldens (SOCP N = 12, QP N = 8), the nonsymmetric
# path's N = 104, and the PSD paths': max-cut (N = 90), min-eig (N = 73)
# and the chordal Solver's N = 127
KERNEL_SHAPES = ((33, 43, 4096), (5, 8, 1024), (56, 72, 1024), (33, 43, 1),
                 (3, 9, 1), (2, 6, 1), (34, 70, 4096), (34, 70, 1),
                 (12, 78, 4096), (36, 37, 256), (54, 73, 1))
# the f64 kernels are timed at N = 76 and these widths: the B = 4096
# batch, the B = 256 batch and the Solver's B = 1
TIMING_WIDTHS = (4096, 256, 1)
NUMPY_CHECK = 4

# ldl_factor bit for bit at these too: (n, m, B) around the factor's
# panel (8) and tile (4) edges, and N = 128
FACTOR_SHAPES = ((3, 5, 300), (4, 5, 300), (33, 43, 300), (56, 72, 300))
# junk written above K's diagonal, which the kernels must not read
JUNK = 1e3
# accuracy bars (tests/test_pallas_dd.py of the reference); the factor
# and the substitution are held to plain bit for bit
TOL_SOLVE = 1e-9      # x vs numpy f64 / plain, relative to max(|x|, 1)
TOL_RESID = 1e-10     # residual vs plain, relative to max(|r|, 1)
TOL_RETURNED_R = 1e-11  # refine's r vs b - K x summed in twice the
#                         precision (kkt_residual_exact), absolute
TOL_OBJ = 1e-7        # objective vs the CPU solve, relative
# f32 kernels (tests/test_pallas_ldl.py): kernel vs plain bit for bit
# (-fmad=false: the same rounding of every operation); L D L^T vs K
# relative to max |K|
TOL_F32_RECON = 1e-4
# the library yardsticks (cuSOLVER's LDL^T through torch.linalg) against
# the kernels' x, relative to max(|x|, 1): they must solve the same system
TOL_LIB_F64 = 1e-9
TOL_LIB_F32 = 1e-4
LIB_SLOW_MS = 100.0
F32_SHAPES = ((16, 5), (76, 4096), (128, 256), (9, 3))  # (N, B)
F32_CHECK = 8
# Solver problems: (name, nass) of the portfolio SOCP, or the goldens
SOLVER_PORTFOLIOS = (32, 64)
# the library KKT backends of the Solver phase, held against "lu" on the
# card and against their own CPU solve
LIBRARY_METHODS = ("qr", "inverse")
# the batch main paths: (path, B, BatchSolver settings); B = 4096 with
# default settings compacts (auto: 0.9 at B >= 1024)
MAIN_PATHS = (("batch_B256", 256, {}), ("batch_B4096", 4096, {}),
              ("batch_B4096_plain", 4096, {"batch_compaction": 0.0}))
TOL_STAGED = 1e-9     # staged vs plain objective, relative
TOL_WARM = 1e-6       # warm vs cold re-solve objective, absolute
TIMING_REPS = 5       # warm solves of each B = 4096 path, alternating
# the nonsymmetric paths: exp_logistic(4, 10, B, seed 5) (N = 104) and
# genpow_family(8, 256, seed 9) (N = 56); (path, B, BatchSolver settings)
NONSYM_EXP = (("exp_B4096", 4096, {}), ("exp_B4096_plain", 4096,
                                       {"batch_compaction": 0.0}),
              ("exp_B256", 256, {}))
NONSYM_GENPOW_B = 256
TOL_GENPOW = 1e-6     # genpow objective vs its analytic optimum, relative
# warm solves of each nonsymmetric and PSD path (5 before the sparse
# phase came: cut to 3 to keep the smoke's time)
NONSYM_REPS = 3
# exp_logistic's iterates part about tenfold an iteration once two
# computations differ at rounding level.  On the card a problem's result
# does not depend on the batch width (kernels per problem, width-free
# products on nonsymmetric layouts), so the staged path and the B = 256
# batch are held to the plain B = 4096 batch bit for bit.  The CPU
# computes log, exp and sums in other orders: its solves are held to the
# same status and objectives within TOL_OBJ, and their iterations are
# printed, not compared.  A few problems end ALMOST_SOLVED in the
# reference too: 3 of 1,000 in its "lu" batch on a CPU (seed 1000) and
# 1 of 600 in its interpret-mode "pallas" batch (B = 300, seeds 5 and
# 1000), so at most 0.5% may here (ROADMAP F8).
NONSYM_OK = ("SOLVED", "ALMOST_SOLVED")
ALMOST_SHARE_MAX = 0.005
# the PSD paths: BatchSolver on problems.maxcut_sdp(12, B, 11) (one PSD
# cone of side 12, N = 90) and problems.psd_min_eig(8, 256, 3) (N = 73)
PSD_NV, PSD_SEED = 12, 11
PSD_MAXCUT = (("maxcut_B4096", 4096, {}), ("maxcut_B4096_plain", 4096,
                                           {"batch_compaction": 0.0}),
              ("maxcut_B256", 256, {}))
PSD_MINEIG = (8, 256, 3)  # (d, B, seed)
TOL_CERT = 1e-7       # the max-cut certificate (diag, lambda_min, gap)
PSD_REPS = 3
# torch.linalg's batched routines against numpy f64 at these sides (the
# PSD cones' stacks), relative to the matrix's norm
PSD_LINALG_SIDES = (3, 6, 8, 12)
PSD_LINALG_B = 4096
TOL_LINALG = 1e-12
# the PSD shapes (N, B) of kernel_timing.PSD_SHAPES that the smoke times
PSD_TIMED = ((90, 4096), (127, 1))
# BASELINE.md's SDP golden, and the reference Solver's iterations and
# objective on the banded rows (its CPU run under "lu")
PSD_GOLDEN_OBJ = 4.840076866013861
PSD_REF = {"banded11": (8, 4.514834284121425),
           "banded12": (9, 4.844922766453251)}

# the sparse paths: SparseSolver on problems.grid_qp(100) (N_kkt =
# 30,000) and on the AUG2D-class QP of problems.make_grid_qp_qps(100)
# (n = 19,800, m = 9,999) through QPS text; f32 fronts at k = 24;
# BatchSparseSolver on problems.grid_qp_family(24, 256, 3) (N_kkt =
# 1,728), q and b varying, then the P and A values too; the host QDLDL
# Solver on these goldens and portfolio rows; a chordal SDP
# (problems.sdp_chordal_banded(11, 2, 6)) through SparseSolver
SPARSE_GRID_K = 100
SPARSE_AUG2D_K = 100
SPARSE_SMALL_K = 24
SPARSE_BATCH = (24, 256, 3)   # (k, B, seed)
SPARSE_REPS = 3               # warm batch solves for problems/s
SPARSE_CHORDAL = (11, 2, 6)   # (nv, bw, seed)
QDLDL_ROWS = ("qp", "lp", "socp", "portfolio64")
TOL_KKT = 1e-7        # host-checked optimality conditions, relative
TOL_AUG2D = 1e-6      # AUG2D-class objective vs scipy's spsolve, relative
TOL_F32_X = 1e-6      # f32 fronts' x vs f64's (tests/test_sparse_solver.py)
TOL_X_SINGLE = 1e-7   # a batch problem's x vs its single solve's
# cuSOLVER's LDL^T through torch.linalg loops over the batch on the host
# (seconds a call at B = 4096): at B = 4096 it is timed at the main
# path's N = 76 only, so that the sparse phase fits the smoke's time
LIBRARY_B4096_N = (76,)
# several cards: ShardedSolver on problems.box_budget_qp(n, m_in, seed),
# A (m_in + 1, n) = 2.1 GB in f64; its objective over several cards
# within TOL_SHARDED_OBJ of one card's, relative; the data-parallel
# batch on the portfolio at DP_BATCH, problems/s over DP_REPS warm solves
SHARDED_QP = (512, 524288, 0)
TOL_SHARDED_OBJ = 1e-8
DP_BATCH = 4096
DP_REPS = 3

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
REPLACES_F32 = {
    "ldl_factor_batched": "cuclarabel_tpu/kkt/pallas_ldl.py:89",
    "ldl_solve_batched": "cuclarabel_tpu/kkt/pallas_ldl.py:114",
}
SOURCE_F32 = "cuclarabel_torch/csrc/ldl_f32.cu"
REPLACES_PROBES = {
    "probe_chain": "scripts/mosaic_probe.py:64",
    "probe_issue": "scripts/mosaic_probe2.py:14",
}
SOURCE_PROBES = "cuclarabel_torch/csrc/probes.cu"
# the wide forms (csrc/ldl_wide.cu), which the wrappers launch above
# N = 128, and the TPU functions they replace
REPLACES_WIDE = {
    "ldl_factor_wide": "cuclarabel_tpu/kkt/pallas_dd.py:1318",
    "ldl_solve_wide": "cuclarabel_tpu/kkt/pallas_dd.py:1346",
    "kkt_residual_wide": "cuclarabel_tpu/kkt/pallas_dd.py:1370",
    "ldl_solve_refine_wide": "cuclarabel_tpu/kkt/pallas_dd.py:1395",
    "ldl_factor_batched_wide": "cuclarabel_tpu/kkt/pallas_ldl.py:89",
    "ldl_solve_batched_wide": "cuclarabel_tpu/kkt/pallas_ldl.py:114",
}
ALSO_REPLACES.update({
    "ldl_solve_wide": "cuclarabel_tpu/kkt/pallas_dd.py:1430",
    "ldl_solve_refine_wide": "cuclarabel_tpu/kkt/pallas_dd.py:1455",
})
SOURCE_WIDE = "cuclarabel_torch/csrc/ldl_wide.cu"
# the segment sums in one fixed order (csrc/segsum.cu), which replace the
# reference's per-cone reductions of the second-order cones (an XLA
# segment_sum) and the equilibration's rectification means
REPLACES_SEGSUM = {"segment_sum": "cuclarabel_tpu/cones/ops.py:59"}
SOURCE_SEGSUM = "cuclarabel_torch/csrc/segsum.cu"
# the wide phase: every wide form against its plain version at (n, m, B):
# N = 129, the portfolio's N = 148 at B = 4096 and 1, N = 169, the
# largest N at which each kernel keeps its triangle in shared memory and
# the next (the factor 220, 221: ldl.factor_form; the refined solve 226,
# 227 at R = 2 and 233, 234 at R = 1: ldl.refine_form; the substitution
# 240, 241: ldl.solve_form) and the nass = 128 portfolio's N = 292; K's
# Hs spread as tests/test_torch_cuda.py draws it (10^(+-3)), where two
# summation orders of a refinement pass agree to 1e-12 (at 10^(+-4) the
# narrow forms' 1e-9 bar)
WIDE_KERNEL_SHAPES = ((5, 124, 5), (65, 83, 4096), (65, 83, 1),
                      (5, 164, 64), (110, 110, 16), (110, 111, 16),
                      (113, 113, 16), (113, 114, 16), (116, 117, 16),
                      (117, 117, 16), (120, 120, 16), (120, 121, 16),
                      (129, 163, 256))
# the shapes where a problem is also solved alone (B = 1), to hold its
# bits to those it has inside the batch: N = 148 at B = 4096
WIDE_ALONE = ((65, 83, 4096),)
# the F14 check: this many solves of portfolio_socp(WIDE_NASS, WIDE_REPEAT_B)
# under "pallas" and under "lu" give one digest each
WIDE_REPEATS, WIDE_REPEAT_B = 3, 256
# the KKT dimension of each wide path
WIDE_PATH_N = {"wide_B4096": 148, "wide_B4096_plain": 148,
               "wide_solver": 148, "wide_B256_n292": 292}
# the wide f64 kernels whose launcher picks a form (shared or streaming)
WIDE_FORM_KERNELS = ("ldl_factor_wide", "ldl_solve_wide",
                     "ldl_solve_refine_wide")
WIDE_SPREAD = 3.0
TOL_WIDE = 1e-12      # residual and refined solve vs plain, relative
# (N, B): the f32 forms at N = 129, 148 and 292, and on both sides of
# the substitution's shared-memory edge (256, 257) and the factor's (320,
# 321)
WIDE_F32_SHAPES = ((129, 5), (148, 4096), (256, 5), (257, 5), (292, 256),
                   (320, 5), (321, 5))
# the "pallas" path above 128: the portfolio at nass = 64 (N = 148),
# B = 4096 staged and plain, its Solver, and nass = 128 (N = 292) at
# B = 256; problems/s of "pallas" and "lu" over WIDE_REPS warm solves
WIDE_NASS, WIDE_B = 64, 4096
WIDE_BIG = (128, 256)  # (nass, B)
WIDE_REPS = 3
# the wide kernels' timed shapes: kernel_timing.WIDE_SHAPES; cuSOLVER's
# LDL^T through torch.linalg is timed at B = 256 only (a host loop over
# the batch), baddbmm for the residual at every shape
WIDE_LIBRARY_B = 256
# P1 at the reference's default and at a ragged small shape; P2 at every
# (R, streams) of its sweep; seeded random inputs and the constants
PROBE_SHAPES = ((83, 4096), (13, 256))  # (N, B)
PROBE_SEEDS = (5, None)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel(a, b, floor=0.0):
    a = a.double()
    b = b.double()
    scale = max(float(b.abs().max()), floor)
    return float((a - b).abs().max()) / scale if scale > 0 else 0.0


# ---------------------------------------------------------------------
# the kernels whose ptxas report is printed, and which must not spill
NO_SPILL = ("ldl_factor_kernel", "kkt_residual_kernel")


def phase_build():
    from cuclarabel_torch.kkt import _build

    info = _build.build()
    _build.load()
    print(f"build: {info['seconds']:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {line.strip()}")
    report = _build.ptxas_report(info["log"])
    for func in NO_SPILL:
        found = {k: v for k, v in report.items()
                 if f"{len(func)}{func}" in k}
        check(bool(found), f"ptxas reported no {func}")
        for name, rec in sorted(found.items()):
            spill = rec.get("spill_stores", 0) + rec.get("spill_loads", 0)
            print(f"ptxas {name}: {rec.get('registers')} registers, "
                  f"{rec.get('spill_stores')} B spill stores, "
                  f"{rec.get('spill_loads')} B spill loads")
            check(spill == 0, f"{name} spills {spill} B")
    return info


def phase_kernels():
    """Each kernel against its plain version on the card.  Returns the
    max abs error per kernel over all shapes."""
    from cuclarabel_torch.kkt import ldl

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    errs = {k: 0.0 for k in REPLACES}

    def factor(K, reg, tag):
        L, Dinv, ok = ldl.ldl_factor(K, reg)
        torch.cuda.synchronize()
        Lp, Dinvp, okp = ldl.ldl_factor_plain(K, reg)
        e = max(rel(L, Lp), rel(Dinv, Dinvp))
        check(bool(ok.all()) and bool(okp.all()), f"factor not ok at {tag}")
        check(torch.equal(L, Lp) and torch.equal(Dinv, Dinvp),
              f"ldl_factor vs plain at {tag}: {e:.2e} (bar: bit for bit)")
        check(bool((L.triu() == 0).all()), f"L not strictly lower at {tag}")
        errs["ldl_factor"] = max(errs["ldl_factor"],
                                 float((L - Lp).abs().max()),
                                 float((Dinv - Dinvp).abs().max()))
        return L, Dinv, e

    def with_junk(Kn):
        junk = np.triu(rng.standard_normal(Kn.shape), 1) * JUNK
        return torch.tensor(Kn + junk, device=dev)

    for n, m, B in FACTOR_SHAPES:
        Kn, regn = make_kkt(rng, B, n, m)
        factor(with_junk(Kn), torch.tensor(regn, device=dev),
               f"N={n + m} B={B}")
    print("ldl_factor bit for bit with plain at (N, B) = "
          + ", ".join(f"({n + m}, {B})" for n, m, B in FACTOR_SHAPES))
    for n, m, B in KERNEL_SHAPES:
        N = n + m
        Kn, regn = make_kkt(rng, B, n, m)
        K = with_junk(Kn)
        reg = torch.tensor(regn, device=dev)
        tag = f"N={N} B={B}"

        L, Dinv, e = factor(K, reg, tag)
        worst = {"ldl_factor": e}
        # how far numpy's x moves in one refinement pass: a kernel that
        # skipped its pass would be this far from the npass = 1 bar
        skip_gap = 0.0

        # refinement runs against the unregularised K: its iterates move
        # from the solution of K + diag(reg) towards that of K, at a rate
        # set by the data (reg (K + diag(reg))^-1); the refined x is held
        # to numpy's own passes, and after two passes to K^-1 b
        c = min(B, NUMPY_CHECK)
        Kc = Kn[:c]
        Kreg = Kc + np.einsum("bi,ij->bij", regn[:c], np.eye(N))
        for R in (1, 2):
            shape = (B, N) if R == 1 else (B, N, R)
            b = torch.tensor(rng.standard_normal(shape), device=dev)
            x0 = torch.tensor(rng.standard_normal(shape), device=dev)
            bref = b.cpu().numpy()[:c].reshape(c, N, R)
            xref, xref_unreg = (
                torch.tensor(np.linalg.solve(M, bref)).reshape(
                    (c,) + shape[1:]) for M in (Kreg, Kc))

            x = ldl.ldl_solve(L, Dinv, b)
            torch.cuda.synchronize()
            xp = ldl.ldl_solve_plain(L, Dinv, b)
            e1 = rel(x, xp, 1.0)
            e2 = rel(x[:c].cpu(), xref, 1.0)
            check(torch.equal(x, xp) and e2 < TOL_SOLVE,
                  f"ldl_solve r={R} at {tag}: vs plain {e1:.2e} (bar: "
                  f"bit for bit), vs numpy {e2:.2e}")
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
                rtrue = kkt_residual_exact(K, xr, b)
                e1 = rel(xr, xrp, 1.0)
                e2 = rel(xr[:c].cpu(), torch.tensor(numpy_refine(
                    Kc, Kreg, bref, npass)).reshape(xref.shape), 1.0)
                e4 = (rel(xr[:c].cpu(), xref_unreg, 1.0) if npass == 2
                      else 0.0)
                e3 = float((rr - rtrue).abs().max())
                if npass == 1:
                    skip_gap = max(skip_gap, rel(
                        torch.tensor(numpy_refine(Kc, Kreg, bref, 0)),
                        torch.tensor(numpy_refine(Kc, Kreg, bref, 1)), 1.0))
                check(e1 < TOL_SOLVE and e2 < TOL_SOLVE and e4 < TOL_SOLVE
                      and e3 < TOL_RETURNED_R,
                      f"ldl_solve_refine r={R} npass={npass} at {tag}: "
                      f"vs plain {e1:.2e}, vs numpy {e2:.2e}, vs K^-1 b "
                      f"{e4:.2e}, returned r {e3:.2e}")
                # the two kernels' residual sums are one and the same
                check(torch.equal(rr, ldl.kkt_residual(K, xr, b)),
                      f"ldl_solve_refine r={R} npass={npass} at {tag}: its "
                      "r differs from kkt_residual's (bar: bit for bit)")
                worst["ldl_solve_refine"] = max(
                    worst.get("ldl_solve_refine", 0.0), e1)
                errs["ldl_solve_refine"] = max(
                    errs["ldl_solve_refine"], float((xr - xrp).abs().max()))
        print(f"kernels ok at {tag}: max error vs plain "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + f"; one refinement pass moves numpy's x by {skip_gap:.2e} "
              f"({'above' if skip_gap > TOL_SOLVE else 'within'} the "
              f"{TOL_SOLVE:.0e} bar: a skipped pass "
              f"{'fails' if skip_gap > TOL_SOLVE else 'would pass'} it)")
    return errs


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    def split(v):
        c = 134217729.0 * v  # 2^27 + 1
        hi = c - (c - v)
        return hi, v - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def kkt_residual_exact(K, x, b):
    """b - K x of the symmetric matrix of K's lower triangle (as
    ldl.kkt_residual reads it), summed as if in twice the precision
    (Ogita-Rump-Oishi Dot2, b the first term).  K (B, N, N), x and b
    (B, N) or (B, N, R).  Not a kernel's plain version: a yardstick for
    the rounding of the kernels' and the plain versions' sums."""
    Ks = torch.tril(K) + torch.tril(K, -1).transpose(1, 2)
    xr = x[:, :, None] if x.dim() == 2 else x
    s = (b[:, :, None] if b.dim() == 2 else b).clone()
    c = torch.zeros_like(s)
    for k in range(Ks.shape[2]):
        p, ep = _two_prod(Ks[:, :, k, None], xr[:, k, None, :])
        s, es = _two_sum(s, -p)
        c = c + (es - ep)
    return (s + c).reshape(b.shape)


def numpy_refine(K, Kreg, b, npass):
    """numpy's x of ldl_solve_refine: the solve of Kreg x = b, then npass
    passes x + Kreg^-1 (b - K x), each accepted per (problem, right-hand
    side) only where it lowers max |b - K x|.  K, Kreg (c, N, N), b
    (c, N, R)."""
    x = np.linalg.solve(Kreg, b)
    r = b - K @ x
    best = np.abs(r).max(axis=1)
    for _ in range(npass):
        xn = x + np.linalg.solve(Kreg, r)
        rn = b - K @ xn
        new = np.abs(rn).max(axis=1)
        take = (new < best)[:, None, :]
        x, r = np.where(take, xn, x), np.where(take, rn, r)
        best = np.minimum(new, best)
    return x


def compare_staged(card, staged, plain, what="batch_B4096",
                   width_ops=None):
    """A staged B = 4096 path against the plain one, problem by problem:
    status and iterations equal, objective within TOL_STAGED relative;
    prints the largest |dx|, |ds|, |dz| and whether the two are bitwise
    equal, and if not, which of the path's operations (width_ops, by
    default the portfolio path's) give a problem a result that depends
    on the batch width."""
    worst = {"x": 0.0, "s": 0.0, "z": 0.0}
    obj = 0.0
    for i, (g, w) in enumerate(zip(staged, plain)):
        check(g.status == w.status, f"staged problem {i}: {g.status.name}, "
              f"plain {w.status.name}")
        check(g.iterations == w.iterations, f"staged problem {i}: "
              f"{g.iterations} iterations, plain {w.iterations}")
        obj = max(obj, abs(g.obj_val - w.obj_val) / abs(w.obj_val))
        for f in worst:
            worst[f] = max(worst[f], float(np.abs(getattr(g, f)
                                                  - getattr(w, f)).max()))
    check(obj <= TOL_STAGED, f"staged vs plain: objective {obj:.2e} "
          f"relative (bar {TOL_STAGED:g})")
    bitwise = not any(worst.values())
    print(f"[{card}] {what} staged vs plain: statuses and iterations "
          f"equal, objective within {obj:.3e} relative, max |dx| "
          f"{worst['x']:.3e}, |ds| {worst['s']:.3e}, |dz| {worst['z']:.3e}, "
          f"bitwise equal: {bitwise}")
    if not bitwise:
        found = (width_ops or width_dependent_ops)()
        print("operations whose per-problem result depends on the batch "
              f"width on this card: {found or 'none found'}")
    return {"bitwise": bitwise, "max_abs_diff": worst, "obj_rel": obj}


def width_dependent_ops(B=4096, keep=300, reps=2, dev="cuda", nass=NASS):
    """The loop's reductions and products at the main path's shapes
    (nass = 32: n = 33, m = 43, the SOC segment sums of the portfolio
    layout; or those of another nass), on B
    rows and on `keep` of them gathered as stage 2 gathers them: the
    names of those whose gathered rows differ from the same rows of the
    full-width result, or from another run at the same width."""
    from cuclarabel_torch.cones.layout import build_layout
    from cuclarabel_torch.cones.ops import plan
    from cuclarabel_torch.problems import portfolio_socp

    _, _, _, cones = portfolio_socp(nass, 1, seed=7)
    layout = build_layout(tuple(cones))
    seg = plan(layout, dev).soc_seg
    n, m = nass + 1, layout.m
    g = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.float64)

    full = {"A": rnd(B, m, n), "x": rnd(B, n, 1), "z": rnd(B, m, 1),
            "v": rnd(B, m)}
    full["w"] = rnd(B, len(seg))
    ops = {
        "torch.bmm (A x)": lambda t: torch.bmm(t["A"], t["x"]),
        "torch.bmm (A' z)": lambda t: torch.bmm(t["A"].transpose(1, 2),
                                                t["z"]),
        "sum(dim=1)": lambda t: t["v"].sum(dim=1),
        "linalg.vector_norm(dim=1)": lambda t: torch.linalg.vector_norm(
            t["v"], dim=1),
        "index_add_ (SOC segment sums)": lambda t: t["w"].new_zeros(
            t["w"].shape[0], layout.nsoc).index_add_(1, seg, t["w"]),
    }
    return width_dependent(ops, full, g, B, keep, reps)


def width_dependent(ops, full, g, B, keep, reps):
    """The names of the ops (each a function of the dict of tensors
    `full`) whose result on `keep` of the B rows, gathered as stage 2
    gathers them, differs from the same rows of the full-width result,
    or from another run at the same width."""
    idx = torch.randperm(B, generator=g, device=full["A"].device)[:keep]
    idx = idx.sort().values
    part = {k: t.index_select(0, idx) for k, t in full.items()}
    found = []
    for name, op in ops.items():
        ref = op(full)
        same = all(torch.equal(op(full), ref) for _ in range(reps))
        if not (same and torch.equal(ref.index_select(0, idx), op(part))):
            found.append(name)
    return found


class StageLaunches:
    """Splits a staged solve's kernel launches between its stages: the
    launch counters are read where each run_passes call of
    parallel/batch.py returns; the first call is stage 1 (the loop's
    init before it counts with it), the second stage 2."""

    def __init__(self):
        from cuclarabel_torch.kkt import ldl
        from cuclarabel_torch.parallel import batch

        self.batch, self.ldl, self.ends = batch, ldl, []
        self.inner = batch.run_passes

    def __enter__(self):
        def observed(*args, **kw):
            out = self.inner(*args, **kw)
            self.ends.append(dict(self.ldl.LAUNCHES))
            return out

        self.batch.run_passes = observed
        return self

    def __exit__(self, *exc):
        self.batch.run_passes = self.inner

    def split(self):
        total = dict(self.ldl.LAUNCHES)
        stage1 = self.ends[0] if self.ends else total
        return {"stage1": stage1,
                "stage2": {k: v - stage1.get(k, 0) for k, v in total.items()
                           if v - stage1.get(k, 0)}}


def phase_main(card):
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import portfolio_socp

    runs = {}
    paths = {}
    for path, B, settings in MAIN_PATHS:
        A, qs, bs, cones = portfolio_socp(NASS, B, seed=7)
        stages = StageLaunches()

        def drive():
            t0 = time.perf_counter()
            solver = ct.BatchSolver(None, qs, A, bs, cones, **settings)
            with stages:
                sols = solver.solve()
            return solver, sols, time.perf_counter() - t0

        (solver, sols, cold), launches = counted(path, drive)
        check(solver.device.type == "cuda", "BatchSolver did not run on CUDA")
        status = [s.status for s in sols]
        check(all(s == ct.SolverStatus.SOLVED for s in status),
              f"{path}: not all SOLVED: "
              f"{sorted(set(s.name for s in status))}")
        for s in sols:
            check(s.x.shape == (qs.shape[1],) and np.isfinite(s.x).all()
                  and np.isfinite(s.obj_val), f"{path}: non-finite result")
        for key in ("ldl_factor/r1", "ldl_solve_refine/r1",
                    "ldl_solve_refine/r2"):
            check(launches.get(key, 0) > 0, f"{path}: {key} never launched")
        quorum = solver.settings.batch_compaction
        want = settings.get("batch_compaction", 0.9 if B >= 1024 else 0.0)
        check(quorum == want, f"{path}: batch_compaction resolved to "
              f"{quorum}, not {want}")
        if quorum > 0.0:
            comp = solver.last_compaction
            check(comp["remainder"] > 0, f"{path}: stage 2 did not run: "
                  f"{comp}")
            split = stages.split()
            print(f"{path} compaction: {json.dumps(comp)}; launches by "
                  f"stage: {json.dumps(split, sort_keys=True)}")
        runs[path] = (A, qs, bs, cones, solver, sols, cold)
        paths[path] = launches

    staged = compare_staged(card, runs["batch_B4096"][5],
                            runs["batch_B4096_plain"][5])

    # the first problems against the port's CPU solve (plain versions)
    A, qs, bs, cones, _, sols, _ = runs["batch_B256"]
    cpu = ct.BatchSolver(None, qs[:CPU_CHECK], A, bs[:CPU_CHECK], cones,
                         device="cpu").solve()
    worst = 0.0
    for g, c in zip(sols[:CPU_CHECK], cpu):
        check(g.status == c.status, f"status {g.status} vs CPU {c.status}")
        worst = max(worst, abs(g.obj_val - c.obj_val) / abs(c.obj_val))
    check(worst <= TOL_OBJ, f"objective vs CPU: {worst:.2e} relative")
    print(f"[{card}] first {CPU_CHECK} problems match the CPU solve: "
          f"max objective difference {worst:.3e} relative")
    return runs, paths, staged


def phase_warm(card, runs):
    """The batch warm path at B = 256: after update_data(q=1.01 q) a
    re-solve warm-started from the previous solutions, every problem
    SOLVED, within TOL_WARM of a cold re-solve, in fewer iterations
    summed.  Returns (launches, record)."""
    import cuclarabel_torch as ct

    _, qs, _, _, solver, prev, _ = runs["batch_B256"]
    solver.update_data(q=qs * 1.01)
    start = tuple(np.stack([getattr(s, f) for s in prev])
                  for f in ("x", "s", "z"))
    warm, launches = counted("batch_B256_warm",
                             lambda: solver.solve(warm_start=start))
    check(launches.get("ldl_factor/r1", 0) > 0,
          "batch_B256_warm: ldl_factor never launched")
    cold = solver.solve()
    solver.update_data(q=qs)
    check(all(s.status == ct.SolverStatus.SOLVED for s in warm),
          "batch_B256_warm: not all SOLVED")
    gap = max(abs(w.obj_val - c.obj_val) for w, c in zip(warm, cold))
    check(gap <= TOL_WARM, f"batch_B256_warm: objective {gap:.2e} from the "
          f"cold re-solve (bar {TOL_WARM:g})")
    iw = sum(s.iterations for s in warm)
    ic = sum(s.iterations for s in cold)
    check(iw < ic, f"batch_B256_warm: {iw} iterations, cold {ic}")
    print(f"[{card}] batch_B256_warm: all SOLVED, {iw} iterations summed "
          f"against {ic} cold, objectives within {gap:.3e} of the cold "
          "re-solve")
    return launches, {"iterations_warm": iw, "iterations_cold": ic,
                      "max_obj_diff": gap}


def counted(name, fn):
    """Drive one main path: the launch counters set to 0 just before fn
    runs and read just after; no plain version may run.  Returns (fn's
    result, the launches by "<kernel>/r<R>", and the segment sums'
    under "segment_sum")."""
    from cuclarabel_torch.cones import segsum
    from cuclarabel_torch.kkt import ldl

    ldl.reset_counts()
    segsum.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(ldl.LAUNCHES) | dict(segsum.LAUNCHES)
    plain = dict(ldl.PLAIN_CALLS) | dict(segsum.PLAIN_CALLS)
    print(f"{name} launches: {json.dumps(launches, sort_keys=True)}")
    check(not plain, f"{name}: plain versions ran on the main path: {plain}")
    return out, launches


def solver_problems():
    """(name, (P, q, A, b, cones)) of the Solver phase: BASELINE.md's QP
    golden and the LP and SOCP goldens of tests/test_basic_lp.py and
    tests/test_basic_socp.py (copied), and the portfolio SOCP of the
    batch path, one problem at each nass of SOLVER_PORTFOLIOS."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import portfolio_socp, socp_golden

    nn3 = [ct.NonnegativeConeT(3), ct.NonnegativeConeT(3)]
    A0 = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    yield "qp", (np.array([[4.0, 1.0], [1.0, 2.0]]), np.ones(2),
                 np.vstack([-A0, A0]),
                 np.array([-1.0, 0.0, 0.0, 1.0, 0.7, 0.7]), nn3)
    A_box = np.vstack([np.eye(3), -np.eye(3)]) * 2.0
    yield "lp", (None, np.array([3.0, -2.0, 1.0]), A_box, np.ones(6), nn3)
    yield "socp", socp_golden()
    for nass in SOLVER_PORTFOLIOS:
        A, q, b, cones = portfolio_socp(nass, 1, seed=7)
        yield f"portfolio{nass}", (None, q[0], A, b[0], cones)


def phase_solver(card):
    """The single-problem Solver on the card, held against the same
    solves on the CPU.  Returns (launches, timing)."""
    import cuclarabel_torch as ct

    problems = dict(solver_problems())
    main = f"portfolio{SOLVER_PORTFOLIOS[0]}"
    rng = np.random.default_rng(4)
    dq = 1e-3 * rng.standard_normal(problems[main][1].shape)

    def drive():
        out = {}
        for name, data in problems.items():
            solver = ct.Solver(*data)
            check(solver.device.type == "cuda", "Solver did not run on CUDA")
            t0 = time.perf_counter()
            sol = solver.solve()
            out[name] = (solver, sol, time.perf_counter() - t0)
        solver, sol, _ = out[main]
        solver.update_q(problems[main][1] + dq)
        t0 = time.perf_counter()
        warm = solver.solve(warm_start=(sol.x, sol.s, sol.z))
        out["warm"] = (solver, warm, time.perf_counter() - t0)
        print("verbose solve of the QP golden on the card:")
        out["verbose"] = (None, ct.Solver(*problems["qp"],
                                          verbose=True).solve(), 0.0)
        return out

    out, launches = counted("solver", drive)
    for key in ("ldl_factor/r1", "ldl_solve_refine/r1",
                "ldl_solve_refine/r2"):
        check(launches.get(key, 0) > 0, f"solver: {key} never launched")

    # the same solves on the CPU: status, objective and iterations
    cpu = {name: ct.Solver(*data, device="cpu") for name, data in
           problems.items()}
    want = {name: s.solve() for name, s in cpu.items()}
    cpu[main].update_q(problems[main][1] + dq)
    want["warm"] = cpu[main].solve(
        warm_start=(want[main].x, want[main].s, want[main].z))
    want["verbose"] = want["qp"]
    for name, (solver, got, secs) in out.items():
        w = want[name]
        err = abs(got.obj_val - w.obj_val) / abs(w.obj_val)
        check(got.status == ct.SolverStatus.SOLVED, f"solver {name}: "
              f"{got.status.name}")
        check(err <= TOL_OBJ, f"solver {name}: objective {err:.2e} "
              "relative from the CPU solve")
        check(got.iterations == w.iterations, f"solver {name}: "
              f"{got.iterations} iterations, {w.iterations} on the CPU")
        method = (solver.get_info()["linear_solver"]["method"]
                  if solver is not None else "")
        print(f"solver {name}: SOLVED in {got.iterations} iterations "
              f"(CPU {w.iterations}), objective {got.obj_val:.12g}, "
              f"{err:.2e} relative from the CPU, {method} {secs * 1e3:.1f} ms")
    for nass in SOLVER_PORTFOLIOS:
        solver = out[f"portfolio{nass}"][0]
        N = solver.n + solver.m
        method = solver.get_info()["linear_solver"]["method"]
        check(method == ("pallas" if N <= 128 else "lu"),
              f"portfolio{nass}: N = {N} took {method}")

    # the N = 76 problem's solve times on the card
    solver, sol, first = out[main]
    solver.update_q(problems[main][1])
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        sol = solver.solve()
        reps.append(time.perf_counter() - t0)
    solver.update_q(problems[main][1] + dq)
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        solver.solve(warm_start=(sol.x, sol.s, sol.z))
        warm.append(time.perf_counter() - t0)
    timing = {"first_ms": first * 1e3,
              "repeat_ms": float(np.median(reps)) * 1e3,
              "warm_start_ms": float(np.median(warm)) * 1e3,
              "iterations": sol.iterations,
              "warm_start_iterations": out["warm"][1].iterations}
    print(f"[{card}] Solver, portfolio nass={SOLVER_PORTFOLIOS[0]} (N=76): "
          f"first solve {timing['first_ms']:.1f} ms, repeat solve "
          f"{timing['repeat_ms']:.1f} ms (median of 5, "
          f"{timing['iterations']} iterations), warm-started re-solve "
          f"after update_q {timing['warm_start_ms']:.1f} ms (median of 3, "
          f"{timing['warm_start_iterations']} iterations)")
    return launches, timing


def phase_solver_backends(card):
    """The Solver's library KKT backends ("qr", "inverse") on the card,
    on the problems of the Solver phase: SOLVED, the objective within
    TOL_OBJ relative of "lu" on the card, and the iterations of the same
    method on the CPU.  Then the N = 76 Solver's profile_phases()."""
    import cuclarabel_torch as ct

    problems = dict(solver_problems())
    for name, data in problems.items():
        lu = ct.Solver(*data, kkt_solve_method="lu").solve()
        for method in LIBRARY_METHODS:
            solver = ct.Solver(*data, kkt_solve_method=method)
            check(solver.device.type == "cuda", "Solver did not run on CUDA")
            got = solver.solve()
            want = ct.Solver(*data, kkt_solve_method=method,
                             device="cpu").solve()
            err = abs(got.obj_val - lu.obj_val) / abs(lu.obj_val)
            check(got.status == ct.SolverStatus.SOLVED,
                  f"solver {name} {method}: {got.status.name}")
            check(err <= TOL_OBJ, f"solver {name} {method}: objective "
                  f"{err:.2e} relative from lu")
            check(got.iterations == want.iterations, f"solver {name} "
                  f"{method}: {got.iterations} iterations, "
                  f"{want.iterations} on the CPU")
            check(solver.get_info()["linear_solver"]["method"] == method,
                  f"solver {name}: {method} not taken")
            print(f"solver {name} {method}: SOLVED in {got.iterations} "
                  f"iterations (CPU {want.iterations}, lu {lu.iterations}),"
                  f" objective {err:.2e} relative from lu")
    main = f"portfolio{SOLVER_PORTFOLIOS[0]}"
    solver = ct.Solver(*problems[main])
    solver.solve()
    phases = {k: v * 1e3 for k, v in solver.profile_phases().items()}
    check(all(v > 0.0 for v in phases.values()),
          f"profile_phases: {phases}")
    print(f"[{card}] Solver {main} (N=76) profile_phases, ms per call: "
          + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()))
    return phases


class PassCounter:
    """Counts the IPM loop passes of the solves run inside it: the
    loop_pass that run_passes calls (ipm/loop.py, and its name in
    parallel/batch.py) is wrapped to count its calls."""

    def __init__(self):
        from cuclarabel_torch.ipm import loop
        from cuclarabel_torch.parallel import batch

        self.mods, self.passes = (loop, batch), 0
        self.inner = loop.run_passes

    def __enter__(self):
        def observed(state, loop_pass, *args):
            def counted_pass(st, unsolved):
                self.passes += 1
                return loop_pass(st, unsolved)

            return self.inner(state, counted_pass, *args)

        for mod in self.mods:
            mod.run_passes = observed
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.run_passes = self.inner


def host_syncs(fn):
    """(fn(), passes, host syncs) of one run: loop passes counted by
    PassCounter, syncs by torch.cuda's sync debug mode, one warning per
    synchronizing call (reads of a count or a flag, copies to the
    host)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, \
            PassCounter() as passes:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return out, passes.passes, syncs


def path_record(card, path, solver, rerun, reps):
    """Launches and host syncs per loop pass, iterations, problems ended
    under Dual scaling, warm problems/s over `reps` solves (median and
    spread) and device busy and idle share of one profiled warm solve
    of a nonsymmetric or PSD path; rerun(r) solves again, nudged by r."""
    from cuclarabel_torch.kkt import ldl

    ldl.reset_counts()
    _, passes, syncs = host_syncs(lambda: rerun(0))
    launches = dict(ldl.LAUNCHES)
    raw = solver.raw if hasattr(solver, "raw") else solver.get_info()
    it = np.atleast_1d(raw["iterations"])
    dual = int(np.sum(np.atleast_1d(raw["scaling"]) == 1))
    wall = []
    for r in range(reps):
        t0 = time.perf_counter()
        rerun(r + 1)
        wall.append((time.perf_counter() - t0) * 1e3)
    busy, nkern, pwall = profiled(lambda t: rerun(reps + 1 + t))
    B = len(it)
    rate = [B * 1e3 / t for t in wall]
    rec = {"B": B, "loop_passes": passes, "host_syncs": syncs,
           "syncs_per_pass": syncs / passes,
           "launches_per_pass": (None if nkern is None
                                 else nkern / passes),
           "kernel_launches": nkern, "ldl_launches": launches,
           "iterations_mean": float(it.mean()),
           "iterations_max": int(it.max()), "dual_only": dual,
           "problems_per_s_median": float(np.median(rate)),
           "problems_per_s": rate, "wall_ms": wall,
           "device_busy_ms": busy, "profiled_wall_ms": pwall,
           "idle_share": None if busy is None else 1.0 - busy / pwall}
    print(f"[{card}] {path}: {passes} loop passes, "
          + ("kernel launches not measured" if nkern is None else
             f"{nkern} kernel launches "
             f"({rec['launches_per_pass']:.1f} per pass)")
          + f", {syncs} host syncs ({rec['syncs_per_pass']:.2f} per pass);"
          f" IPM iterations mean {rec['iterations_mean']:.2f} max "
          f"{rec['iterations_max']}, {dual} of {B} ended under Dual "
          f"scaling; warm {rec['problems_per_s_median']:.1f} problems/s "
          f"(median of {reps}, spread {min(rate):.1f} to {max(rate):.1f}); "
          f"one profiled warm solve: {busy_text(busy, pwall)}", flush=True)
    return rec


def nonsym_solver_problems():
    """(name, (P, q, A, b, cones)) of the nonsymmetric Solver goldens:
    tests/test_basic_exp.py's and tests/test_basic_pow.py's pow and
    genpow data (copied), and exp_logistic's problem 0 (N = 104)."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import exp_logistic

    A1 = np.hstack([np.ones((1, 3)), np.zeros((1, 4))])
    A2 = np.hstack([np.zeros((3, 2)), -np.eye(3), np.zeros((3, 2))])
    A3 = np.zeros((3, 7))
    A3[0, 0] = A3[1, 2] = A3[2, 4] = -1.0
    yield "exp", (np.eye(7) * 1e-1,
                  np.array([1.0, 0.5, -2.0, -0.1, 1.0, 3.0, 0.0]),
                  np.vstack([A1, A2, A3]),
                  np.concatenate([[10.0], np.zeros(6)]),
                  [ct.ZeroConeT(1), ct.NonnegativeConeT(3),
                   ct.ExponentialConeT()])
    q = np.zeros(6)
    q[2] = q[5] = -1.0
    A = -np.vstack([np.eye(6), [[1.0, 2.0, 0.0, 3.0, 0.0, 0.0]],
                    [[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]]])
    b = np.concatenate([np.zeros(6), [-3.0, -1.0]])
    yield "pow", (np.zeros((6, 6)), q, A, b,
                  [ct.PowerConeT(0.6), ct.PowerConeT(0.1), ct.ZeroConeT(1),
                   ct.ZeroConeT(1)])
    yield "genpow", (np.zeros((6, 6)), q,
                     np.vstack([-np.eye(6), -A[6:]]),
                     np.concatenate([np.zeros(6), -b[6:]]),
                     [ct.GenPowerConeT([0.6, 0.4], 1),
                      ct.GenPowerConeT([0.1, 0.9], 1), ct.ZeroConeT(2)])
    P, qs, As, bs, cones = exp_logistic(4, 10, 1, 5)
    yield "exp_logistic", (P, qs[0], As[0], bs[0], cones)


NONSYM_GOLDEN_OBJ = {"exp": -54.41243965302268, "pow": -1.8458,
                     "genpow": -1.8458}
TOL_GOLDEN = 1e-3     # the goldens' own bar (tests/test_basic_*.py)


def compare_nonsym(card, what, got, want, bitwise):
    """Two solves of the same exp_logistic problems, problem by problem:
    the same status; with `bitwise`, the same iterations and x, s and z
    to the bit, else objectives within TOL_OBJ relative and the problems
    whose iterations differ counted."""
    worst, n_iter = 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.status == w.status and g.status.name in NONSYM_OK,
              f"{what} problem {i}: {g.status.name}, {w.status.name}")
        err = abs(g.obj_val - w.obj_val) / abs(w.obj_val)
        worst = max(worst, err)
        n_iter += g.iterations != w.iterations
        if bitwise:
            check(g.iterations == w.iterations and all(
                np.array_equal(getattr(g, f), getattr(w, f))
                for f in ("x", "s", "z")),
                  f"{what} problem {i}: {g.iterations} and {w.iterations} "
                  "iterations, or x, s, z not bitwise equal")
        else:
            check(err <= TOL_OBJ, f"{what} problem {i}: objective "
                  f"{err:.2e} relative (bar {TOL_OBJ:g})")
    print(f"[{card}] {what}: {len(got)} problems, the same statuses, "
          + ("bitwise equal" if bitwise else
             f"objectives within {worst:.3e} relative, iterations differ "
             f"in {n_iter}"))
    return {"problems": len(got), "bitwise": bitwise,
            "iterations_differ": n_iter, "obj_rel": worst}


def phase_nonsym(card):
    """The exponential and generalised power cones' paths on the card,
    each driven with the launch counters set to 0 just before it and read
    just after.  Returns (launches by path, records)."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import exp_logistic, genpow_family

    paths, recs, runs = {}, {}, {}
    for path, B, settings in NONSYM_EXP:
        P, qs, A, bs, cones = exp_logistic(4, 10, B, 5)
        stages = StageLaunches()

        def drive():
            solver = ct.BatchSolver(P, qs, A, bs, cones, **settings)
            with stages:
                return solver, solver.solve()

        (solver, sols), launches = counted(path, drive)
        check(solver.device.type == "cuda", f"{path}: not on CUDA")
        for key in ("ldl_factor/r1", "ldl_solve_refine/r1"):
            check(launches.get(key, 0) > 0, f"{path}: {key} never launched")
        check(launches.get("ldl_solve_refine/r2", 0) == 0,
              f"{path}: a pair solve ran (the unit start has none)")
        status = collections.Counter(s.status.name for s in sols)
        check(set(status) <= set(NONSYM_OK), f"{path}: statuses {status}")
        share = status["ALMOST_SOLVED"] / B
        check(share <= ALMOST_SHARE_MAX, f"{path}: {share:.1%} "
              "ALMOST_SOLVED")
        print(f"[{card}] {path}: {dict(status)} ({share:.2%} ALMOST_SOLVED)")
        for s in sols:
            check(s.x.shape == (qs.shape[1],) and np.isfinite(s.x).all()
                  and np.isfinite(s.obj_val), f"{path}: non-finite result")
        if solver.settings.batch_compaction > 0.0:
            comp = solver.last_compaction
            check(comp["remainder"] > 0, f"{path}: stage 2 did not run")
            print(f"{path} compaction: {json.dumps(comp)}; launches by "
                  f"stage: {json.dumps(stages.split(), sort_keys=True)}")
        paths[path] = launches
        runs[path] = (P, qs, A, bs, cones, solver, sols)

    # staged and B = 256 against the plain B = 4096 batch, bit for bit,
    # and the first problems against the CPU
    plain = runs["exp_B4096_plain"][6]
    compare_nonsym(card, "exp_B4096 staged vs plain", runs["exp_B4096"][6],
                   plain, bitwise=True)
    compare_nonsym(card, "exp_B256 vs the first 256 of exp_B4096_plain",
                   runs["exp_B256"][6], plain[:256], bitwise=True)
    P, qs, A, bs, cones, _, sols = runs["exp_B4096"]
    cpu = ct.BatchSolver(P, qs[:CPU_CHECK], A[:CPU_CHECK], bs[:CPU_CHECK],
                         cones, device="cpu").solve()
    compare_nonsym(card, f"exp_B4096 first {CPU_CHECK} vs the CPU",
                   sols[:CPU_CHECK], cpu, bitwise=False)

    P, qs, A, bs, cones, optima = genpow_family(8, NONSYM_GENPOW_B, 9)

    def drive_gp():
        solver = ct.BatchSolver(P, qs, A, bs, cones)
        return solver, solver.solve()

    (gp_solver, gp_sols), paths["genpow_B256"] = counted("genpow_B256",
                                                         drive_gp)
    check(paths["genpow_B256"].get("ldl_factor/r1", 0) > 0,
          "genpow_B256: ldl_factor never launched")
    err = max(abs(s.obj_val - o) / abs(o) for s, o in zip(gp_sols, optima))
    check(all(s.status == ct.SolverStatus.SOLVED for s in gp_sols),
          "genpow_B256: not all SOLVED")
    check(err <= TOL_GENPOW, f"genpow_B256: {err:.2e} from the optima")
    print(f"[{card}] genpow_B256: all SOLVED, within {err:.3e} relative of "
          "the analytic optima")

    problems = dict(nonsym_solver_problems())

    def drive_solver():
        out = {}
        for name, data in problems.items():
            solver = ct.Solver(*data)
            check(solver.device.type == "cuda", "Solver did not run on CUDA")
            out[name] = (solver, solver.solve())
        return out

    out, paths["solver_nonsym"] = counted("solver_nonsym", drive_solver)
    for name, (solver, got) in out.items():
        want = ct.Solver(*problems[name], device="cpu").solve()
        check(got.status == ct.SolverStatus.SOLVED,
              f"solver {name}: {got.status.name}")
        check(got.iterations == want.iterations,
              f"solver {name}: {got.iterations} iterations, CPU "
              f"{want.iterations}")
        err = abs(got.obj_val - want.obj_val) / abs(want.obj_val)
        check(err <= TOL_OBJ, f"solver {name}: {err:.2e} from the CPU")
        if name in NONSYM_GOLDEN_OBJ:
            check(abs(got.obj_val - NONSYM_GOLDEN_OBJ[name]) < TOL_GOLDEN,
                  f"solver {name}: objective {got.obj_val} off its golden")
        N = solver.n + solver.m
        print(f"solver {name}: SOLVED in {got.iterations} iterations (CPU "
              f"{want.iterations}), objective {got.obj_val:.12g}, "
              f"{err:.2e} relative from the CPU, N = {N}, scaling "
              f"{int(solver.get_info()['scaling'])}")

    def batch_rerun(solver, qs):
        def rerun(r):
            solver.update_data(q=qs * (1.0 + 1e-9 * r))
            solver.solve()
        return rerun

    for path in ("exp_B4096", "exp_B4096_plain", "exp_B256"):
        _, qs_p, _, _, _, solver, _ = runs[path]
        recs[path] = path_record(card, path, solver,
                                   batch_rerun(solver, qs_p), NONSYM_REPS)
    recs["genpow_B256"] = path_record(card, "genpow_B256", gp_solver,
                                        batch_rerun(gp_solver, qs),
                                        NONSYM_REPS)
    solver = out["exp_logistic"][0]
    q0 = problems["exp_logistic"][1]

    def solver_rerun(r):
        solver.update_q(q0 * (1.0 + 1e-9 * r))
        solver.solve()

    recs["solver_exp_n104"] = path_record(card, "solver_exp_n104", solver,
                                            solver_rerun, NONSYM_REPS)
    return paths, recs


# ---------------------------------------------------------------------
# the PSD paths

def phase_psd_linalg(card):
    """torch.linalg's batched decompositions on the card, as the PSD
    cones call them (cones/psd.py), against numpy f64 on the same
    matrices at each side of PSD_LINALG_SIDES and B = PSD_LINALG_B:
    eigenvalues, and each factorisation's reconstruction and the
    orthogonality of its factors, relative to the matrix's norm (the
    largest over the batch).  Returns the errors by routine."""
    rng = np.random.default_rng(8)
    errs = {}

    def hold(name, r, err):
        check(err <= TOL_LINALG, f"torch.linalg.{name} at r={r}: {err:.2e} "
              f"relative to the norm (bar {TOL_LINALG:g})")
        errs[name] = max(errs.get(name, 0.0), err)

    for r in PSD_LINALG_SIDES:
        G = rng.standard_normal((PSD_LINALG_B, 1, r, r))
        # symmetric, and SPD with eigenvalues spread over 10^-6 ... 10^6
        # as late iterates have them
        Msym = (G + np.swapaxes(G, -1, -2)) / 2
        Q = np.linalg.qr(rng.standard_normal((PSD_LINALG_B, 1, r, r)))[0]
        lam = 10.0 ** rng.uniform(-6, 6, (PSD_LINALG_B, 1, r))
        Spd = (Q * lam[..., None, :]) @ np.swapaxes(Q, -1, -2)
        Spd = (Spd + np.swapaxes(Spd, -1, -2)) / 2
        eye = np.eye(r)

        def norm(M):
            return np.linalg.norm(M, ord=2, axis=(-2, -1))

        def rel_err(got, want, M):
            return float((np.abs(got - want).max(axis=(-2, -1))
                          / norm(M)).max())

        for M in (Msym, Spd):
            t = torch.tensor(M, device="cuda")
            e = torch.linalg.eigvalsh(t).cpu().numpy()
            hold("eigvalsh", r, float((np.abs(e - np.linalg.eigvalsh(M))
                                       .max(-1) / norm(M)).max()))
            lam_t, V = (a.cpu().numpy() for a in torch.linalg.eigh(t))
            hold("eigh", r, rel_err((V * lam_t[..., None, :])
                                    @ np.swapaxes(V, -1, -2), M, M))
            hold("eigh", r, float(np.abs(np.swapaxes(V, -1, -2) @ V
                                         - eye).max()))
        L, info = torch.linalg.cholesky_ex(torch.tensor(Spd, device="cuda"))
        check(not bool(info.any()), f"cholesky_ex failed at r={r}")
        L = L.cpu().numpy()
        hold("cholesky_ex", r, rel_err(L @ np.swapaxes(L, -1, -2), Spd, Spd))
        # the scaling update's SVD takes L2' L1 of two Cholesky factors
        W = np.linalg.cholesky(Spd) @ G
        U, sv, Vh = (a.cpu().numpy() for a in torch.linalg.svd(
            torch.tensor(W, device="cuda")))
        hold("svd", r, float((np.abs(sv - np.linalg.svd(W, compute_uv=False))
                              .max(-1) / norm(W)).max()))
        hold("svd", r, rel_err((U * sv[..., None, :]) @ Vh, W, W))
        hold("svd", r, float(max(
            np.abs(np.swapaxes(U, -1, -2) @ U - eye).max(),
            np.abs(Vh @ np.swapaxes(Vh, -1, -2) - eye).max())))
    print(f"[{card}] torch.linalg against numpy f64 at r = "
          f"{', '.join(map(str, PSD_LINALG_SIDES))}, B = {PSD_LINALG_B}: "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(errs.items()))
          + f" (relative to the norm; bar {TOL_LINALG:g})", flush=True)
    return errs


def maxcut_certificate(sols, Ls):
    """The relaxation's primal certificate, for every problem: X = mat(z)
    with diag(X) within TOL_CERT of 1, lambda_min(X) >= -TOL_CERT ||X||
    and sum(y) within TOL_CERT relative of <L/4, X>.  Returns the worst
    of each."""
    from cuclarabel_torch.problems import smat

    nv = Ls.shape[1]
    X = np.stack([smat(s.z, nv) for s in sols])
    y = np.stack([s.x for s in sols]).sum(axis=1)
    diag = float(np.abs(np.diagonal(X, axis1=1, axis2=2) - 1.0).max())
    lmin = float((-np.linalg.eigvalsh(X)[:, 0]
                  / np.linalg.norm(X, ord=2, axis=(1, 2))).max())
    gap = float((np.abs(y - (Ls / 4.0 * X).sum(axis=(1, 2)))
                 / np.abs(y)).max())
    check(diag <= TOL_CERT and lmin <= TOL_CERT and gap <= TOL_CERT,
          f"max-cut certificate: |diag(X) - 1| {diag:.2e}, -lambda_min(X) "
          f"/ ||X|| {lmin:.2e}, sum(y) vs <L/4, X> {gap:.2e} (bar "
          f"{TOL_CERT:g})")
    return {"diag": diag, "lambda_min": lmin, "gap": gap}


def psd_width_dependent_ops(B=4096, keep=300, reps=2, dev="cuda"):
    """width_dependent_ops at the max-cut path's shapes: the products of
    a symmetric layout (torch.bmm on A (B, 78, 12)) and the PSD cones'
    batched torch.linalg routines and matrix products on (B, 1, 12, 12)
    stacks."""
    g = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.float64)

    n, m, r = PSD_NV, PSD_NV * (PSD_NV + 1) // 2, PSD_NV
    G = rnd(B, 1, r, r)
    full = {"A": rnd(B, m, n), "x": rnd(B, n, 1), "z": rnd(B, m, 1),
            "G": G, "S": G @ G.transpose(-1, -2) + torch.eye(
                r, dtype=torch.float64, device=dev)}
    ops = {
        "torch.bmm (A x)": lambda t: torch.bmm(t["A"], t["x"]),
        "torch.bmm (A' z)": lambda t: torch.bmm(t["A"].transpose(1, 2),
                                                t["z"]),
        "matmul (B, 1, 12, 12)": lambda t: t["G"] @ t["S"],
        "linalg.cholesky_ex": lambda t: torch.linalg.cholesky_ex(t["S"])[0],
        "linalg.svd": lambda t: torch.linalg.svd(t["G"])[1],
        "linalg.eigvalsh": lambda t: torch.linalg.eigvalsh(t["S"]),
        "linalg.eigh": lambda t: torch.linalg.eigh(t["S"])[0],
    }
    return width_dependent(ops, full, g, B, keep, reps)


def psd_solver_problems():
    """(name, (P, q, A, b, cones), Solver settings) of the PSD Solver
    rows: tests/test_basic_sdp.py's golden and its mixed NN + SOC + PSD
    problem (copied) under the default method ("pallas", B = 1) and
    "lu"; tests/test_sdp_chordal.py's PSD + power cone problem (copied)
    under its 12 chordal settings; problems.sdp_chordal_banded(nv, 2, 6)
    at nv = 11 (N = 127 after decomposition, "pallas") and 12 (N = 141,
    "lu"); tests/test_qr_backend.py's nearest-PSD projection at nv = 24
    (copied; N = 600) under "lu" and "qr"."""
    import itertools

    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import sdp_chordal_banded, svec

    sdp = (np.eye(6), np.zeros(6), np.eye(6),
           np.array([-3.0, 1.0, 4.0, 1.0, 2.0, 5.0]),
           [ct.PSDTriangleConeT(3)])
    rng = np.random.default_rng(42)
    F = rng.standard_normal((6, 6))
    A_soc = np.zeros((3, 6))
    A_soc[1, 0] = A_soc[2, 1] = -1.0
    A_psd = np.zeros((3, 6))
    A_psd[0, 0] = A_psd[2, 1] = -1.0
    A_psd[1, 2] = -np.sqrt(2.0)
    mixed = (F @ F.T + 0.1 * np.eye(6), rng.standard_normal(6),
             np.vstack([np.eye(6), A_soc, A_psd]),
             np.concatenate([np.full(6, 2.0), [1.5, 0.0, 0.0],
                             [1.0, 0.0, 1.0]]),
             [ct.NonnegativeConeT(6), ct.SecondOrderConeT(3),
              ct.PSDTriangleConeT(2)])
    for name, data in (("sdp", sdp), ("mixed_sdp_socp", mixed)):
        yield name, data, {}
        yield f"{name}_lu", data, {"kkt_solve_method": "lu"}

    sq2 = np.sqrt(2.0)
    cols = ([24], [7, 10, 22], [8], [12, 15, 25], [9], [13], [18, 21, 26],
            [0, 23, 27])
    vals = ([-1.0], [-sq2, -1.0, -1.0], [-sq2], [-sq2, -1.0, -1.0], [-sq2],
            [-sq2], [-sq2, -1.0, -1.0], [-1.0, -1.0, -1.0])
    A = np.zeros((28, 8))
    for j, (rows, v) in enumerate(zip(cols, vals)):
        A[rows, j] = v
    b = np.zeros(28)
    b[1:7] = [3.0, 2.0 * sq2, 2.0, sq2, sq2, 3.0]
    chordal = (np.zeros((8, 8)), np.eye(8)[0] * -1.0, A, b,
               [ct.NonnegativeConeT(1), ct.PSDTriangleConeT(6),
                ct.PowerConeT(1.0 / 3.0), ct.PowerConeT(0.5)])
    for compact, dual, merge in itertools.product(
            (False, True), (False, True),
            ("clique_graph", "parent_child", "none")):
        yield (f"chordal_{'compact' if compact else 'standard'}_"
               f"{'dual' if dual else 'nodual'}_{merge}", chordal,
               {"chordal_decomposition_compact": compact,
                "chordal_decomposition_complete_dual": dual,
                "chordal_decomposition_merge_method": merge})
    for nv in (11, 12):
        yield f"banded{nv}", sdp_chordal_banded(nv, 2, 6), {}

    rng = np.random.default_rng(0)
    M = rng.standard_normal((24, 24))
    sd = 24 * 25 // 2
    proj = (np.eye(sd), -svec((M + M.T) / 2.0), -np.eye(sd), np.zeros(sd),
            [ct.PSDTriangleConeT(24)])
    for method in ("lu", "qr"):
        yield f"projection24_{method}", proj, {"kkt_solve_method": method}


def phase_psd(card):
    """The PSD paths on the card, each driven with the launch counters set
    to 0 just before it and read just after.  Returns (launches by path,
    records)."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import maxcut_sdp, psd_min_eig

    paths, recs, runs = {}, {"linalg": phase_psd_linalg(card)}, {}
    for path, B, settings in PSD_MAXCUT:
        P, qs, A, bs, cones, Ls = maxcut_sdp(PSD_NV, B, PSD_SEED)
        stages = StageLaunches()

        def drive():
            solver = ct.BatchSolver(P, qs, A, bs, cones, **settings)
            with stages:
                return solver, solver.solve()

        (solver, sols), launches = counted(path, drive)
        check(solver.device.type == "cuda", f"{path}: not on CUDA")
        for key in ("ldl_factor/r1", "ldl_solve_refine/r1",
                    "ldl_solve_refine/r2"):
            check(launches.get(key, 0) > 0, f"{path}: {key} never launched")
        status = collections.Counter(s.status.name for s in sols)
        check(set(status) == {"SOLVED"}, f"{path}: statuses {dict(status)}")
        cert = maxcut_certificate(sols, Ls)
        it = np.array([s.iterations for s in sols])
        print(f"[{card}] {path}: all {B} SOLVED, iterations mean "
              f"{it.mean():.2f} max {it.max()}; certificate |diag(X) - 1| "
              f"{cert['diag']:.2e}, -lambda_min(X) / ||X|| "
              f"{cert['lambda_min']:.2e}, sum(y) vs <L/4, X> "
              f"{cert['gap']:.2e}", flush=True)
        if solver.settings.batch_compaction > 0.0:
            comp = solver.last_compaction
            check(comp["remainder"] > 0, f"{path}: stage 2 did not run")
            print(f"{path} compaction: {json.dumps(comp)}; launches by "
                  f"stage: {json.dumps(stages.split(), sort_keys=True)}")
            recs[f"{path}_compaction"] = comp
        recs[f"{path}_certificate"] = cert
        paths[path] = launches
        runs[path] = (qs, solver, sols)
    for key in ("ldl_solve/r1", "kkt_residual/r1"):
        check(sum(paths[p].get(key, 0) for p, _, _ in PSD_MAXCUT) > 0,
              f"max-cut paths: {key} never launched")

    recs["maxcut_staged_vs_plain"] = compare_staged(
        card, runs["maxcut_B4096"][2], runs["maxcut_B4096_plain"][2],
        "maxcut_B4096", psd_width_dependent_ops)
    qs, _, sols = runs["maxcut_B4096"]
    P, _, A, bs, cones, _ = maxcut_sdp(PSD_NV, CPU_CHECK, PSD_SEED)
    cpu = ct.BatchSolver(P, qs[:CPU_CHECK], A, bs, cones,
                         device="cpu").solve()
    worst = 0.0
    for i, (g, c) in enumerate(zip(sols[:CPU_CHECK], cpu)):
        check(g.status == c.status, f"maxcut problem {i}: {g.status.name}, "
              f"CPU {c.status.name}")
        worst = max(worst, abs(g.obj_val - c.obj_val) / abs(c.obj_val))
    check(worst <= TOL_OBJ, f"maxcut first {CPU_CHECK} vs the CPU: "
          f"{worst:.2e} relative")
    print(f"[{card}] maxcut_B4096 first {CPU_CHECK} vs the CPU: the same "
          f"statuses, objectives within {worst:.3e} relative; iterations "
          f"card {[s.iterations for s in sols[:CPU_CHECK]]}, CPU "
          f"{[s.iterations for s in cpu]}", flush=True)

    d, B, seed = PSD_MINEIG
    P, qs_e, A, bs, cones, optima = psd_min_eig(d, B, seed)

    def drive_eig():
        solver = ct.BatchSolver(P, qs_e, A, bs, cones)
        return solver, solver.solve()

    (eig_solver, eig_sols), paths["mineig_B256"] = counted("mineig_B256",
                                                           drive_eig)
    for key in ("ldl_factor/r1", "ldl_solve_refine/r1",
                "ldl_solve_refine/r2"):
        check(paths["mineig_B256"].get(key, 0) > 0,
              f"mineig_B256: {key} never launched")
    check(all(s.status == ct.SolverStatus.SOLVED for s in eig_sols),
          "mineig_B256: not all SOLVED")
    err = max(abs(s.obj_val - o) for s, o in zip(eig_sols, optima))
    check(err <= TOL_OBJ, f"mineig_B256: {err:.2e} from lambda_min(C)")
    print(f"[{card}] mineig_B256: all SOLVED, within {err:.3e} of "
          "lambda_min(C)")

    rows = list(psd_solver_problems())

    def drive_solver():
        out = {}
        for name, data, kw in rows:
            solver = ct.Solver(*data, **kw)
            check(solver.device.type == "cuda", "Solver did not run on CUDA")
            out[name] = (solver, solver.solve())
        return out

    out, paths["solver_psd"] = counted("solver_psd", drive_solver)
    check(paths["solver_psd"].get("ldl_factor/r1", 0) > 0,
          "solver_psd: ldl_factor never launched")
    for name, data, kw in rows:
        solver, got = out[name]
        want = ct.Solver(*data, device="cpu", **kw).solve()
        N = solver.n + solver.m
        method = solver.get_info()["linear_solver"]["method"]
        check(got.status == ct.SolverStatus.SOLVED,
              f"solver {name}: {got.status.name}")
        check(got.iterations == want.iterations, f"solver {name}: "
              f"{got.iterations} iterations, CPU {want.iterations}")
        err = abs(got.obj_val - want.obj_val) / abs(want.obj_val)
        check(err <= TOL_OBJ, f"solver {name}: {err:.2e} from the CPU")
        ref = ""
        if name.startswith("sdp"):
            check(abs(got.obj_val - PSD_GOLDEN_OBJ) <= TOL_OBJ,
                  f"solver {name}: objective {got.obj_val} off its golden")
        if name in PSD_REF:
            ref_it, ref_obj = PSD_REF[name]
            check(abs(got.obj_val - ref_obj) <= TOL_OBJ * abs(ref_obj),
                  f"solver {name}: objective {got.obj_val}, the "
                  f"reference's {ref_obj}")
            check(method == ("pallas" if N <= 128 else "lu"),
                  f"solver {name}: N = {N} took {method}")
            ref = f", the reference's {ref_it} (CPU, lu)"
        print(f"solver {name}: SOLVED in {got.iterations} iterations (CPU "
              f"{want.iterations}{ref}), objective {got.obj_val:.12g}, "
              f"{err:.2e} relative from the CPU, N = {N}, {method}"
              + (", decomposed" if solver.chordal_info is not None else ""))

    def batch_rerun(solver, q):
        def rerun(r):
            solver.update_data(q=q * (1.0 + 1e-9 * r))
            solver.solve()
        return rerun

    for path, _, _ in PSD_MAXCUT:
        qs, solver, _ = runs[path]
        recs[path] = path_record(card, path, solver, batch_rerun(solver, qs),
                                 PSD_REPS)
    recs["mineig_B256"] = path_record(card, "mineig_B256", eig_solver,
                                      batch_rerun(eig_solver, qs_e),
                                      PSD_REPS)
    # a chordally decomposed Solver takes no data update: each warm solve
    # solves the same problem again (nothing carries over between solves)
    solver = out["banded11"][0]
    recs["solver_chordal_n127"] = path_record(
        card, "solver_chordal_n127", solver, lambda r: solver.solve(),
        PSD_REPS)
    return paths, recs


# ---------------------------------------------------------------------
# the sparse paths (phase 8)

def sparse_kkt_launches(solver, Pv, Av):
    """Kernel launches and device busy ms of one sparse factorization,
    one refined solve and one paired refined solve of `solver`'s KKT
    system (a SparseSolver's or a BatchSparseSolver's; Hs of the
    identity scaling, right-hand sides of ones), each under
    torch.profiler."""
    from cuclarabel_torch.cones import ops as cone_ops
    from cuclarabel_torch.kernel_timing import kernel_events
    from cuclarabel_torch.kkt.sparse_tpu import make_sparse_tpu_kkt
    from cuclarabel_torch.profiling import busy_ms

    factorize, solve, _ = make_sparse_tpu_kkt(
        solver.n, solver.m, solver.settings, solver.layout, solver._sp,
        device=solver.device)
    B = Av.shape[0]
    scal = cone_ops.set_identity_scaling(solver.layout, B, solver.device)
    parts = cone_ops.sparse_hs_values(solver.layout, scal,
                                      cone_ops.sparse_hs_plan(solver.layout),
                                      B, solver.device)
    rx = torch.ones(B, solver.n, dtype=torch.float64, device=solver.device)
    rz = torch.ones(B, solver.m, dtype=torch.float64, device=solver.device)
    fac, ok = factorize(Pv, Av, parts)
    check(bool(ok.all()), "sparse factorization at the identity scaling "
          "failed")
    out = {}
    for what, fn in (("factor", lambda: factorize(Pv, Av, parts)),
                     ("solve", lambda: solve(fac, rx, rz)),
                     ("solve_pair", lambda: solve.pair(fac, rx, rz, rx,
                                                       rz))):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = kernel_events(prof)
        out[what] = {"launches": len(kern), "busy_ms": busy_ms(kern),
                     "wall_ms": wall}
        if what != "factor":
            out[what]["refinement_passes"] = int(res[-1].max())
    return out


def sparse_row(card, name, solver, cold_ms, rerun, peak, estimate,
               kkt=None, measured=None):
    """The record of one sparse row: cold and warm wall ms, iterations,
    loop passes and host syncs per pass, the launches per pass, per
    factorization and per refined solve, device busy and idle share of
    one profiled solve, and peak device memory beside the plan's
    estimate; rerun(r) solves again, nudged by r.  measured = (warm ms,
    loop passes, host syncs) of solves the caller ran already, else two
    more solves give them."""
    if measured is None:
        (_, passes, syncs) = host_syncs(lambda: rerun(0))
        t0 = time.perf_counter()
        rerun(1)
        warm = (time.perf_counter() - t0) * 1e3
    else:
        warm, passes, syncs = measured
    busy, nkern, pwall = profiled(lambda t: rerun(2 + t))
    raw = solver.raw if hasattr(solver, "raw") else solver.get_info()
    it = np.atleast_1d(raw["iterations"])
    rec = {"cold_ms": cold_ms, "warm_ms": warm,
           "iterations_mean": float(it.mean()),
           "iterations_max": int(it.max()), "loop_passes": passes,
           "host_syncs": syncs, "syncs_per_pass": syncs / passes,
           "kernel_launches": nkern,
           "launches_per_pass": None if nkern is None else nkern / passes,
           "device_busy_ms": busy, "profiled_wall_ms": pwall,
           "idle_share": None if busy is None else 1.0 - busy / pwall,
           "max_memory_allocated": peak, "plan_memory_estimate": estimate,
           "kkt": kkt}
    print(f"[{card}] {name}: cold {cold_ms:.1f} ms, warm {warm:.1f} ms, "
          f"iterations mean {rec['iterations_mean']:.2f} max "
          f"{rec['iterations_max']}, {passes} loop passes, {syncs} host "
          f"syncs ({rec['syncs_per_pass']:.2f} per pass), "
          + ("kernel launches not measured" if nkern is None else
             f"{nkern} kernel launches ({rec['launches_per_pass']:.1f} per "
             "pass)")
          + f"; one profiled solve: {busy_text(busy, pwall)}; peak device "
          f"memory {peak / 1e6:.1f} MB"
          + ("" if estimate is None else
             f" (plan estimate {estimate / 1e6:.1f} MB)"), flush=True)
    if kkt is not None:
        print(f"[{card}] {name} KKT: " + ", ".join(
            f"{k} {v['launches']} launches, {v['wall_ms']:.1f} ms wall, "
            f"{v['busy_ms']:.2f} ms busy"
            + (f", {v['refinement_passes']} refinement passes"
               if "refinement_passes" in v else "")
            for k, v in kkt.items()), flush=True)
    return rec


def plan_estimate(solver):
    """The NumericPlan's memory estimate of `solver`'s sparse KKT (at its
    factor width)."""
    from cuclarabel_torch.kkt.sparse_tpu import make_sparse_tpu_kkt

    factorize, _, host_bufs = make_sparse_tpu_kkt(
        solver.n, solver.m, solver.settings, solver.layout, solver._sp,
        device=solver.device)
    fbytes = 4 if solver.settings.kkt_factor_precision == "float32" else 8
    return factorize.plan.memory_estimate_bytes(
        int(host_bufs["kmap"].shape[0]), factor_bytes=fbytes)


def cold(make):
    """(make(), wall ms, peak device memory): a first construction and
    solve, symbolic analysis included."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = make()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated())


def kkt_conditions(P, q, A, b, sol, zero=0):
    """The optimality conditions of a QP with nonnegative cones (after
    `zero` zero-cone rows, whose s must vanish and whose z is free),
    recomputed in numpy f64 on the host from the returned x, s, z, each
    relative to the size of its terms: primal and dual residuals, s and
    z in the cone, and the duality gap.  P: the upper triangle, scipy
    sparse, or None."""
    import scipy.sparse as sp

    Pf = (P + sp.triu(P, 1).T) if P is not None else None
    x, s, z = sol.x, sol.s, sol.z
    Ax, ATz = A @ x, A.T @ z
    Px = Pf @ x if Pf is not None else np.zeros_like(x)
    inf = lambda v: float(np.abs(v).max()) if v.size else 0.0  # noqa
    out = {
        "primal": inf(Ax + s - b) / max(1.0, inf(b), inf(Ax), inf(s)),
        "dual": inf(Px + q + ATz) / max(1.0, inf(q), inf(Px), inf(ATz)),
        "s_cone": max(0.0, -float(s[zero:].min())) / max(1.0, inf(s)),
        "z_cone": max(0.0, -float(z[zero:].min())) / max(1.0, inf(z)),
        "gap": abs(x @ Px + q @ x + b @ z) / max(
            1.0, abs(x @ Px), abs(q @ x), abs(b @ z)),
    }
    if zero:
        out["s_zero"] = inf(s[:zero]) / max(1.0, inf(s))
    return out


def phase_sparse(card):
    """The sparse paths on the card, each driven with the LDL^T kernels'
    launch counters set to 0 just before it and read just after (the
    sparse paths run none of csrc/'s kernels: the multifrontal is plain
    torch, QDLDL host C++).  Returns (launches by path, records)."""
    import scipy.sparse as sp

    import cuclarabel_torch as ct
    from cuclarabel_torch import problems, qps

    paths, recs = {}, {}

    # -- the grid QP at full width: N_kkt = 30,000
    k = SPARSE_GRID_K
    P, q, A, b, cones = problems.grid_qp(k)

    def drive_grid():
        return cold(lambda: (lambda s: (s, s.solve()))(
            ct.SparseSolver(P, q, A, b, cones)))

    ((solver, sol), cold_ms, peak), paths["sparse_grid100"] = counted(
        "sparse_grid100", drive_grid)
    check(solver.device.type == "cuda", "SparseSolver: not on CUDA")
    info = solver.get_info()["linear_solver"]
    check(info["kkt_dim"] == 3 * k * k, f"grid QP: N_kkt {info['kkt_dim']}")
    check(sol.status == ct.SolverStatus.SOLVED,
          f"grid QP: {sol.status.name}")
    check(sol.r_prim < 1e-8 and sol.r_dual < 1e-8,
          f"grid QP: r_prim {sol.r_prim:.2e}, r_dual {sol.r_dual:.2e}")
    cond = kkt_conditions(P, q, A, b, sol)
    check(max(cond.values()) <= TOL_KKT, f"grid QP: host-checked "
          f"optimality {cond}")
    t0 = time.perf_counter()
    again = solver.solve()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(sol.x, again.x) and np.array_equal(sol.z, again.z)
          and sol.iterations == again.iterations,
          "grid QP: a second solve is not bitwise equal")
    memo = dict(solver._sp._kkt_memo)
    solver.update_data(q=1.01 * q)
    t0 = time.perf_counter()
    upd, passes, syncs = host_syncs(solver.solve)
    upd_ms = (time.perf_counter() - t0) * 1e3
    check(solver._sp._kkt_memo.keys() == memo.keys() and all(
        solver._sp._kkt_memo[key] is memo[key] for key in memo),
        "grid QP: update_data ran a new symbolic analysis")
    check(upd.status == ct.SolverStatus.SOLVED,
          f"grid QP after update_data: {upd.status.name}")
    cond_upd = kkt_conditions(P, 1.01 * q, A, b, upd)
    check(max(cond_upd.values()) <= TOL_KKT,
          f"grid QP after update_data: {cond_upd}")
    print(f"[{card}] sparse grid QP k={k}: N_kkt {info['kkt_dim']}, "
          f"{info['levels']} levels, {info['supernodes']} supernodes, nnzL "
          f"{info['nnzL']}; SOLVED in {sol.iterations} iterations, r_prim "
          f"{sol.r_prim:.2e}, r_dual {sol.r_dual:.2e}, host-checked "
          + ", ".join(f"{kk} {v:.2e}" for kk, v in cond.items())
          + f"; a second solve bitwise equal; update_data(q=1.01 q) "
          f"re-solved in {upd.iterations} iterations, {upd_ms:.1f} ms, no "
          "new symbolic analysis", flush=True)
    qg = 1.01 * q

    def grid_rerun(r):
        solver.update_data(q=qg * (1.0 + 1e-9 * r))
        solver.solve()

    recs["sparse_grid100"] = sparse_row(
        card, "sparse_grid100", solver, cold_ms, grid_rerun, peak,
        plan_estimate(solver),
        sparse_kkt_launches(solver, solver._dev["Pv"], solver._dev["Av"]),
        measured=(warm_ms, passes, syncs))
    recs["sparse_grid100"].update(kkt_check=cond, info=info,
                                  update_ms=upd_ms)

    # -- the AUG2D class through QPS text
    text = problems.make_grid_qp_qps(SPARSE_AUG2D_K)
    p = qps.parse_qps(text)
    P2, q2, A2, b2, cones2, sgn_c0 = qps.to_clarabel(p)

    def drive_aug2d():
        return cold(lambda: (lambda s: (s, s.solve()))(
            ct.SparseSolver(P2, q2, A2, b2, cones2)))

    ((aug, asol), acold, apeak), paths["sparse_aug2d"] = counted(
        "sparse_aug2d", drive_aug2d)
    want = problems.grid_qp_reference(SPARSE_AUG2D_K)
    got = qps.qps_objective(sgn_c0, asol.obj_val)
    err = abs(got - want) / abs(want)
    check(asol.status == ct.SolverStatus.SOLVED,
          f"AUG2D class: {asol.status.name}")
    check(err <= TOL_AUG2D, f"AUG2D class: objective {got} vs scipy's "
          f"{want}, {err:.2e} relative")
    print(f"[{card}] AUG2D class k={SPARSE_AUG2D_K}: n {q2.shape[0]}, m "
          f"{b2.shape[0]}, SOLVED in {asol.iterations} iterations, "
          f"objective {got!r} vs scipy spsolve {want!r} ({err:.2e} "
          "relative)", flush=True)

    def aug_rerun(r):
        aug.update_data(q=q2 * (1.0 + 1e-9 * r))
        aug.solve()

    recs["sparse_aug2d"] = sparse_row(
        card, "sparse_aug2d", aug, acold, aug_rerun, apeak,
        plan_estimate(aug),
        sparse_kkt_launches(aug, aug._dev["Pv"], aug._dev["Av"]))
    recs["sparse_aug2d"].update(objective=got, reference=want,
                                rel_err=err)

    # -- f32 fronts (tests/test_sparse_solver.py:281-292's bar)
    P3, q3, A3, b3, cones3 = problems.grid_qp(SPARSE_SMALL_K)
    s64 = ct.SparseSolver(P3, q3, A3, b3, cones3).solve()
    s32 = ct.SparseSolver(P3, q3, A3, b3, cones3,
                          kkt_factor_precision="float32").solve()
    dx = float(np.abs(s32.x - s64.x).max())
    check(s32.status == ct.SolverStatus.SOLVED
          and s32.r_prim < 1e-8 and s32.r_dual < 1e-8,
          f"f32 fronts: {s32.status.name}, r_prim {s32.r_prim:.2e}, "
          f"r_dual {s32.r_dual:.2e}")
    check(dx <= TOL_F32_X, f"f32 fronts: x {dx:.2e} from f64's")
    print(f"[{card}] f32 fronts k={SPARSE_SMALL_K}: SOLVED in "
          f"{s32.iterations} iterations (f64 {s64.iterations}), r_prim "
          f"{s32.r_prim:.2e}, r_dual {s32.r_dual:.2e}, x within {dx:.2e} "
          "of the f64 fronts'", flush=True)
    recs["sparse_f32"] = {"iterations": s32.iterations,
                          "iterations_f64": s64.iterations, "dx": dx}

    # -- the batch: q, b varying, then P and A values varying
    kb, B, seed = SPARSE_BATCH
    batches = {}
    for path, vary in (("sparse_batch_B256", False),
                       ("sparse_batch_B256_values", True)):
        P4, qs, A4, bs, cones4, Pv, Av = problems.grid_qp_family(
            kb, B, seed, vary_values=vary)

        def drive_batch():
            return cold(lambda: (lambda s: (s, s.solve()))(
                ct.BatchSparseSolver(P4, qs, A4, bs, cones4, P_vals=Pv,
                                     A_vals=Av)))

        ((batch, bsols), bcold, bpeak), paths[path] = counted(path,
                                                              drive_batch)
        status = collections.Counter(s.status.name for s in bsols)
        check(set(status) == {"SOLVED"}, f"{path}: statuses {dict(status)}")
        spp = batch._sp
        worst = 0.0
        for i in range(CPU_CHECK):
            Pi = P4 if Pv is None else sp.coo_matrix(
                (Pv[i], (spp.P_rows, spp.P_cols)), shape=P4.shape).tocsc()
            Ai = A4 if Av is None else sp.coo_matrix(
                (Av[i], (spp.A_rows, spp.A_cols)), shape=A4.shape).tocsc()
            one = ct.SparseSolver(Pi, qs[i], Ai, bs[i], cones4,
                                  presolve_enable=False).solve()
            check(one.status == bsols[i].status
                  and one.iterations == bsols[i].iterations,
                  f"{path} problem {i}: {bsols[i].status.name} in "
                  f"{bsols[i].iterations}, alone {one.status.name} in "
                  f"{one.iterations}")
            worst = max(worst, float(np.abs(one.x - bsols[i].x).max()))
        check(worst <= TOL_X_SINGLE, f"{path}: x {worst:.2e} from single "
              "solves")
        rates, walls = [], []
        for r in range(SPARSE_REPS):
            t0 = time.perf_counter()
            batch.update_data(q=qs * (1.0 + 1e-9 * (r + 1)))
            if r == 0:
                _, passes, syncs = host_syncs(batch.solve)
            else:
                batch.solve()
            walls.append((time.perf_counter() - t0) * 1e3)
            rates.append(B * 1e3 / walls[-1])
        it = np.array([s.iterations for s in bsols])
        print(f"[{card}] {path}: all {B} SOLVED at k={kb} (N_kkt "
              f"{3 * kb * kb}), iterations mean {it.mean():.2f} max "
              f"{it.max()}; the first {CPU_CHECK} with single SparseSolver "
              f"solves' statuses and iterations, x within {worst:.2e}; "
              f"{np.median(rates):.2f} problems/s (median of {SPARSE_REPS},"
              f" spread {min(rates):.2f} to {max(rates):.2f})", flush=True)
        batches[path] = (batch, qs, bcold, bpeak, worst, rates,
                         (float(np.median(walls)), passes, syncs))
    batch, qs, bcold, bpeak, worst, rates, measured = batches[
        "sparse_batch_B256"]

    def batch_rerun(r):
        batch.update_data(q=qs * (1.0 + 1e-9 * (r + 10)))
        batch.solve()

    Pvb, Avb = batch._slab_args[0][:2]  # one card: one slab
    recs["sparse_batch_B256"] = sparse_row(
        card, "sparse_batch_B256", batch, bcold, batch_rerun, bpeak,
        plan_estimate(batch), sparse_kkt_launches(batch, Pvb, Avb),
        measured=measured)
    recs["sparse_batch_B256"].update(
        problems_per_s_median=float(np.median(rates)), problems_per_s=rates,
        single_x_err=worst,
        values_problems_per_s=batches["sparse_batch_B256_values"][5],
        values_single_x_err=batches["sparse_batch_B256_values"][4])

    # -- the host QDLDL backend of the dense Solver
    rows = [(name, data) for name, data in solver_problems()
            if name in QDLDL_ROWS]

    def drive_qdldl():
        return {name: cold(lambda data=data: (lambda s: (s, s.solve()))(
            ct.Solver(*data, direct_solve_method="qdldl")))
            for name, data in rows}

    qd, paths["solver_qdldl"] = counted("solver_qdldl", drive_qdldl)
    for name, data in rows:
        (qsolver, got), _, _ = qd[name]
        lu = ct.Solver(*data, kkt_solve_method="lu").solve()
        check(qsolver.device.type == "cuda", "qdldl Solver: not on CUDA")
        check(got.status == ct.SolverStatus.SOLVED,
              f"qdldl {name}: {got.status.name}")
        check(got.iterations == lu.iterations, f"qdldl {name}: "
              f"{got.iterations} iterations, lu {lu.iterations}")
        err = abs(got.obj_val - lu.obj_val) / max(1.0, abs(lu.obj_val))
        check(err <= TOL_OBJ, f"qdldl {name}: objective {err:.2e} from lu")
        print(f"[{card}] qdldl Solver {name}: SOLVED in {got.iterations} "
              f"iterations (lu {lu.iterations}), objective "
              f"{got.obj_val:.12g}, {err:.2e} from lu", flush=True)
    (qsolver, _), qcold, qpeak = qd[QDLDL_ROWS[-1]]
    qq = qsolver._qs / (qsolver._c * qsolver._d)

    def qdldl_rerun(r):
        qsolver.update_data(q=qq * (1.0 + 1e-9 * r))
        qsolver.solve()

    recs["solver_qdldl_portfolio64"] = sparse_row(
        card, "solver_qdldl_portfolio64", qsolver, qcold, qdldl_rerun,
        qpeak, None)

    # -- a chordally decomposed SDP through the sparse path
    nv, bw, cseed = SPARSE_CHORDAL
    _, q5, A5, b5, cones5 = problems.sdp_chordal_banded(nv, bw, cseed)

    def drive_chordal():
        return (lambda s: (s, s.solve()))(
            ct.SparseSolver(None, q5, sp.csc_matrix(A5), b5, cones5))

    (csolver, csol), paths["sparse_chordal_banded11"] = counted(
        "sparse_chordal_banded11", drive_chordal)
    dense = ct.Solver(None, q5, A5, b5, cones5).solve()
    err = abs(csol.obj_val - dense.obj_val) / max(1.0, abs(dense.obj_val))
    check(csolver.chordal_info is not None, "chordal SDP: not decomposed")
    check(csol.status == ct.SolverStatus.SOLVED,
          f"chordal SDP: {csol.status.name}")
    check(err <= TOL_OBJ, f"chordal SDP: objective {err:.2e} from the "
          "dense Solver's")
    print(f"[{card}] sparse chordal SDP banded nv={nv}: SOLVED in "
          f"{csol.iterations} iterations (dense Solver "
          f"{dense.iterations}), objective {csol.obj_val:.12g}, {err:.2e} "
          f"from the dense Solver's; N_kkt "
          f"{csolver.get_info()['linear_solver']['kkt_dim']}", flush=True)
    recs["sparse_chordal_banded11"] = {
        "iterations": csol.iterations, "dense_iterations": dense.iterations,
        "objective": csol.obj_val, "rel_err": err}
    for path, launches in paths.items():
        dense = {k: v for k, v in launches.items() if k != "segment_sum"}
        check(not dense, f"{path}: the LDL^T kernels ran on a sparse "
              f"path: {dense}")
    return paths, recs


def phase_segment_sum(card):
    """The segment-sum kernel against its plain version (index_add_ on
    the CPU, which adds in the kernel's order) bit for bit, on the main
    path's segments: the second-order cones of the nass = NASS portfolio
    over the gathered (B, msoc) vector and its rectification segments
    over the m-vector, at B = 256 and 4096, and one problem alone against
    its batch.  Then at B = 4096 its device time beside its bound, its
    plain version's time on the card and index_add_'s (the library call,
    one call where the segments' columns are the vector's own).  Returns
    ({kernel: max abs error}, {kernel: times})."""
    from cuclarabel_torch.cones import segsum
    from cuclarabel_torch.cones.layout import build_layout
    from cuclarabel_torch.parallel.batch import _rect_plan
    from cuclarabel_torch.problems import portfolio_socp

    layout = build_layout(tuple(portfolio_socp(NASS, 1, seed=7)[3]))
    rng = np.random.default_rng(5)
    err, by_shape = 0.0, {}
    for tag, seg in (("soc", layout.soc_seg), ("rect", _rect_plan(layout)[0])):
        segs, segs_cpu = (segsum.Segments(seg, d) for d in ("cuda", "cpu"))
        for B in (256, 4096):
            vals = torch.tensor(rng.standard_normal((B, len(seg))))
            vd = vals.cuda()
            got = segsum.segment_sum(vd, segs)
            want = segsum.segment_sum_plain(vals, segs_cpu)
            e = float((got.cpu() - want).abs().max())
            check(torch.equal(got.cpu(), want), f"segment_sum {tag} at "
                  f"B={B}: {e:.2e} from plain (bar: bit for bit)")
            check(torch.equal(segsum.segment_sum(vd[7:8], segs), got[7:8]),
                  f"segment_sum {tag} at B={B}: problem 7 alone differs")
            err = max(err, e)
        nbytes = 8 * B * (segs.size + segs.nseg) + 4 * segs.idx.numel()
        bms, by = kt.bound_ms(nbytes, B * segs.size)
        key = ("segment_sum", "segment_sum_kernel")
        ms = kt.device_ms({key: lambda: segsum.segment_sum(vd, segs)},
                          50)[key]
        plain_ms = cuda_ms(lambda: segsum.segment_sum_plain(vd, segs), 20)
        lib_ms = None
        if segs.size == len(seg):  # every column in a segment, in order
            lib_ms = cuda_ms(lambda: vd.new_zeros(B, segs.nseg).index_add_(
                1, segs.seg, vd), 20)
        by_shape[f"{tag}_B{B}"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bms, "bound_by": by, "nseg": segs.nseg,
            "width": segs.width, "entries": segs.size}
        print(f"[{card}] segment_sum {tag} at B={B} ({segs.nseg} segments "
              f"of up to {segs.width} of {len(seg)} columns): device "
              f"{ms:.4f} ms, bound {bms:.6f} ms ({by}), plain "
              f"{plain_ms:.4f} ms, library "
              + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none"),
              flush=True)
    print(f"segment_sum bit for bit with plain at B = 256 and 4096, alone "
          f"as in its batch (NASS = {NASS})")
    front = by_shape["soc_B4096"]
    return {"segment_sum": err}, {"segment_sum": dict(
        {k: front[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")}, by_shape=by_shape)}


def phase_kernels_f32():
    """The f32 kernels against their plain versions on the card, bit for
    bit, with numpy's reconstruction of K and the inertia of D.  Returns
    the max abs error per kernel over all shapes."""
    from cuclarabel_torch.kkt import ldl_f32

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    errs = {k: 0.0 for k in REPLACES_F32}
    for N, B in F32_SHAPES:
        Kn, n, m = make_qd_kkt(rng, B, N)
        K = torch.tensor(Kn, dtype=torch.float32, device=dev)
        b = torch.tensor(rng.standard_normal((B, N)), dtype=torch.float32,
                         device=dev)
        tag = f"N={N} B={B}"
        L, Dinv = ldl_f32.ldl_factor_batched(K)
        x = ldl_f32.ldl_solve_batched(L, Dinv, b)
        torch.cuda.synchronize()
        check(L.dtype == Dinv.dtype == x.dtype == torch.float32,
              f"f32 kernels at {tag}: not f32")
        Lp, Dinvp = ldl_f32.ldl_factor_batched_plain(K)
        xp = ldl_f32.ldl_solve_batched_plain(L, Dinv, b)
        eF = max(float((L - Lp).abs().max()), float((Dinv - Dinvp).abs().max()))
        eS = float((x - xp).abs().max())
        check(eF == 0.0 and eS == 0.0, f"f32 kernels vs plain at {tag}: "
              f"factor {eF:.2e}, solve {eS:.2e} (bar: bit for bit)")
        c = min(B, F32_CHECK)
        Ln = np.tril(L[:c].double().cpu().numpy(), -1) + np.eye(N)
        D = 1.0 / Dinv[:c].double().cpu().numpy()
        rec = max(np.abs(Ln[i] @ np.diag(D[i]) @ Ln[i].T - Kn[i]).max()
                  / np.abs(Kn[i]).max() for i in range(c))
        check(rec < TOL_F32_RECON, f"f32 factor at {tag}: reconstruction "
              f"{rec:.2e} relative")
        Dall = 1.0 / Dinv.double()
        check(bool(((Dall > 0).sum(dim=1) == n).all()
                   and ((Dall < 0).sum(dim=1) == m).all()),
              f"f32 factor at {tag}: inertia is not ({n}, {m})")
        errs["ldl_factor_batched"] = max(errs["ldl_factor_batched"], eF)
        errs["ldl_solve_batched"] = max(errs["ldl_solve_batched"], eS)
        print(f"f32 kernels ok at {tag}: bit for bit with plain, "
              f"reconstruction {rec:.2e} relative, inertia ({n}, {m})")
    return errs


def phase_f32_path():
    """The f32 entry points at (76, 4096).  Returns (launches, inputs
    and outputs for the timing)."""
    import cuclarabel_torch as ct

    N, B = 76, 4096
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    Kn, _, _ = make_qd_kkt(rng, B, N)
    bn = rng.standard_normal((B, N))
    K = torch.tensor(Kn, dtype=torch.float32, device=dev)
    b = torch.tensor(bn, dtype=torch.float32, device=dev)

    def drive():
        L, Dinv = ct.ldl_factor_batched(K)
        return L, Dinv, ct.ldl_solve_batched(L, Dinv, b)

    (L, Dinv, x), launches = counted("f32", drive)
    for key in ("ldl_factor_batched/r1", "ldl_solve_batched/r1"):
        check(launches.get(key, 0) > 0, f"f32: {key} never launched")
    xc = x[:F32_CHECK].double().cpu().numpy()
    check(bool(torch.isfinite(x).all()) and x.shape == (B, N),
          "f32 path: non-finite x")
    res = np.abs(np.einsum("bij,bj->bi", Kn[:F32_CHECK], xc)
                 - bn[:F32_CHECK]).max()
    check(res < 1e-3, f"f32 path: residual {res:.2e} (bar 1e-3)")
    print(f"f32 path at N={N} B={B}: max |K x - b| {res:.2e} over the first "
          f"{F32_CHECK} problems")
    return launches, (K, b, L, Dinv)


def phase_probes():
    """The probe kernels against their plain versions on the card, bit
    for bit (-fmad=false: the same rounding of every operation): each P1
    variant at PROBE_SHAPES, with D's output equal to A's, and each P2
    (R, streams) of the sweep, on seeded random inputs and on the
    reference's constants.  Returns the max abs error per kernel."""
    from cuclarabel_torch.probes import mosaic_probe as p1
    from cuclarabel_torch.probes import mosaic_probe2 as p2

    errs = {k: 0.0 for k in REPLACES_PROBES}

    def hold(kernel, tag, got, want):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{kernel} {tag}: shape {tuple(got.shape)} or non-finite")
        e = float((got - want).abs().max())
        check(torch.equal(got, want), f"{kernel} {tag}: {e:.2e} from plain "
              "(bar: bit for bit)")
        errs[kernel] = max(errs[kernel], e)

    for seed in PROBE_SEEDS:
        kind = "constants" if seed is None else f"seed {seed}"
        for N, B in PROBE_SHAPES:
            x, y = p1.inputs((N, N, B), seed, "cuda")
            outs = {}
            for variant, rows, _ in p1.SWEEP:
                tag = f"{p1.name(variant, rows)} at N={N} B={B}, {kind}"
                outs[p1.name(variant, rows)] = o = p1.chain(x, y, variant,
                                                            rows)
                torch.cuda.synchronize()
                hold("probe_chain", tag, o, p1.chain_plain(x, y, variant,
                                                           rows))
            for r in p1.CHUNK_ROWS:
                check(torch.equal(outs[f"D{r}"], outs["A"]),
                      f"probe_chain D{r} differs from A at N={N} B={B}")
            print(f"probe_chain ok at N={N} B={B}, {kind}: every variant "
                  "bit for bit with plain, D equal to A")
        for R, streams in p2.SWEEP:
            x, y = p1.inputs((R, p2.LANES), seed, "cuda")
            o = p2.run(x, y, p2.OPS, streams)
            torch.cuda.synchronize()
            hold("probe_issue", f"R={R} s={streams}, {kind}", o,
                 p2.make_plain(x, y, p2.OPS, streams))
        print(f"probe_issue ok, {kind}: every (R, streams) of the sweep "
              "bit for bit with plain")
    return errs


def phase_probes_path(card):
    """The probes' entry points, P1's sweep at the reference's default
    (83, 4096) and P2's sweep, with the launch counters; then each plain
    version's time.  Returns (launches, {kernel: timing row})."""
    from cuclarabel_torch.probes import mosaic_probe as p1
    from cuclarabel_torch.probes import mosaic_probe2 as p2

    N, B = PROBE_SHAPES[0]
    (chain_rows, issue_rows), launches = counted(
        "probes", lambda: (p1.sweep(N, B), p2.sweep()))
    for variant, rows, _ in p1.SWEEP:
        key = f"probe_chain/{p1.name(variant, rows)}"
        check(launches.get(key, 0) > 0, f"probes: {key} never launched")
    for R, streams in p2.SWEEP:
        key = f"probe_issue/{p2.name(R, streams)}"
        check(launches.get(key, 0) > 0, f"probes: {key} never launched")

    x, y = p1.inputs((N, N, B), device="cuda")
    plain = {p1.name(v, r): cuda_ms(
        lambda v=v, r=r: p1.chain_plain(x, y, v, r), 3)
        for v, r, _ in p1.SWEEP}
    for R, streams in p2.SWEEP:
        xi, yi = p1.inputs((R, p2.LANES), device="cuda")
        plain[p2.name(R, streams)] = cuda_ms(
            lambda xi=xi, yi=yi, s=streams: p2.make_plain(xi, yi, p2.OPS, s),
            3)
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "op_per_s",
            "issue_pct", "sm_clock", "ptxas")
    times = {}
    for kernel, rows in (("probe_chain", chain_rows),
                         ("probe_issue", issue_rows)):
        by_shape = {}
        for row in rows:
            row["plain_ms"] = plain[row["name"]]
            by_shape[row["name"]] = {k: row[k] for k in keep}
            extra = "stream_ms" if kernel == "probe_chain" else "sm_bound_ms"
            by_shape[row["name"]][extra] = row[extra]
            print(f"[{card}] {kernel} {row['name']}: device {row['ms']:.4f} "
                  f"ms, plain {row['plain_ms']:.3f} ms, bound "
                  f"{row['bound_ms']:.6f} ms ({row['bound_by']}), "
                  f"{row['issue_pct']:.1f}% of the issue rate")
        # the first of the sweep heads the row: P1's A, P2's R = 8
        head = by_shape[rows[0]["name"]]
        times[kernel] = {"ms": head["ms"], "plain_ms": head["plain_ms"],
                         "library_ms": None, "bound_ms": head["bound_ms"],
                         "bound_by": head["bound_by"], "by_shape": by_shape}
    return launches, times


def solve_ms(solver, qs, r):
    """One warm solve's wall ms, on q nudged by r (so that nothing is
    reused), the host clock around a call that ends in a host copy."""
    solver.update_data(q=qs * (1.0 + 1e-9 * (r + 1)))
    t0 = time.perf_counter()
    solver.solve()
    return (time.perf_counter() - t0) * 1e3


# the f64 LDL^T kernels as the profiler names them, whose launches the
# wrappers count (kkt/ldl.py's LAUNCHES)
LDL_TRACE_NAMES = ("ldl_factor_kernel", "ldl_solve_kernel<",
                   "kkt_residual_kernel<", "ldl_solve_refine_kernel<")
PROFILE_TRIES = 2


def profiled(solve):
    """(device busy ms, kernel launches, wall ms) of solve(t), a warm
    solve, under torch.profiler (device activity): busy is the union of
    the kernels' intervals (profiling.busy_ms).  The profiler may drop
    a session's events: a trace is kept only if it holds as many
    launches of the LDL^T kernels as their wrappers counted, and else
    solve(t + 1) is profiled again, up to PROFILE_TRIES sessions; after
    that busy and launches are None (not measured)."""
    from cuclarabel_torch.kernel_timing import kernel_events
    from cuclarabel_torch.kkt import ldl
    from cuclarabel_torch.profiling import busy_ms

    acts = [torch.profiler.ProfilerActivity.CUDA]
    for t in range(PROFILE_TRIES):
        before = sum(ldl.LAUNCHES.values())
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            solve(t)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = kernel_events(prof)
        want = sum(ldl.LAUNCHES.values()) - before
        got = sum(any(n in e["name"] for n in LDL_TRACE_NAMES)
                  for e in kern)
        if got == want:
            return busy_ms(kern), len(kern), wall
        print(f"chip_smoke: the profiler's trace holds {got} of the {want}"
              f" LDL^T kernel launches of a solve (session {t + 1} of "
              f"{PROFILE_TRIES})", file=sys.stderr, flush=True)
    return None, None, wall


def busy_text(busy, wall):
    if busy is None:
        return (f"device busy not measured (the profiler dropped "
                f"launches), wall {wall:.1f} ms")
    return (f"device busy {busy:.2f} ms of {wall:.1f} ms, idle "
            f"{1.0 - busy / wall:.1%}")


def phase_timing(card, runs):
    """Warm problems/s: B = 256 (median of 3), then the B = 4096 staged
    and plain paths in turns (TIMING_REPS each, the first of each pair
    alternating), with the median and the spread (min to max), and the
    device busy time of one profiled warm solve of each."""
    out = {}
    A, qs, _, _, solver, _, cold = runs["batch_B256"]
    ts = [solve_ms(solver, qs, r) for r in range(3)]
    it, ir = solver.raw["iterations"], solver.raw["ir_count"]
    warm = float(np.median(ts))
    print(f"[{card}] B=256: warm {solver.B * 1e3 / warm:.1f} problems/s "
          f"(median of 3:"
          f" {warm:.1f} ms; first solve {cold:.2f} s), IPM iterations mean "
          f"{it.mean():.2f} max {it.max()}, {it.sum() / warm * 1e3:.0f} "
          "problem-iterations/s, refinement passes per iteration "
          f"{ir.sum() / it.sum():.3f}")
    pair = ("batch_B4096", "batch_B4096_plain")
    ms = {p: [] for p in pair}
    for r in range(TIMING_REPS):
        for p in (pair if r % 2 == 0 else pair[::-1]):
            ms[p].append(solve_ms(runs[p][4], runs[p][1], r))
    for p in pair:
        solver, cold = runs[p][4], runs[p][6]
        it, ir = solver.raw["iterations"], solver.raw["ir_count"]
        med = float(np.median(ms[p]))
        b, launches, wall = profiled(lambda t: solver.solve())
        rate = [solver.B * 1e3 / t for t in ms[p]]
        out[p] = {"problems_per_s_median": solver.B * 1e3 / med,
                  "problems_per_s": rate, "wall_ms": ms[p],
                  "device_busy_ms": b, "kernel_launches": launches,
                  "profiled_wall_ms": wall}
        print(f"[{card}] {p}: warm {solver.B * 1e3 / med:.1f} problems/s "
              f"(median of "
              f"{TIMING_REPS}: {med:.1f} ms; spread {min(rate):.1f} to "
              f"{max(rate):.1f} problems/s; first solve {cold:.2f} s), one "
              f"profiled warm solve: {busy_text(b, wall)} in {launches} "
              f"launches; IPM iterations mean "
              f"{it.mean():.2f} max {it.max()}, refinement passes per "
              f"iteration {ir.sum() / it.sum():.3f}")
    return out


def ldl_library_operands(L, Dinv):
    """The port's factor in the compact form of torch.linalg.ldl_factor:
    strict-lower L with D on the diagonal, and identity pivots (1-based,
    all 1x1 blocks), so that torch.linalg.ldl_solve (cuSOLVER's sytrs on
    the card) solves (I+L) D (I+L)' x = b as the kernels do."""
    B, N = Dinv.shape
    LD = torch.tril(L, -1) + torch.diag_embed(1.0 / Dinv)
    piv = torch.arange(1, N + 1, dtype=torch.int32, device=L.device)
    return LD, piv.expand(B, N).contiguous()


def check_library(name, got, want, tol):
    """A library yardstick solves the kernel's system: its x against the
    kernel's."""
    e = rel(got, want, 1.0)
    check(e < tol, f"library call for {name}: x {e:.2e} from the kernel's")
    print(f"library call for {name}: x within {e:.2e} of the kernel's")


def library_calls(op, forms):
    """{(name, R): one PyTorch call computing the same function} for each
    form of `forms` that has one, on the operands of
    kernel_timing.operands, each first checked against the kernel's
    result: torch.baddbmm for the residual, cuSOLVER's LDL^T through
    torch.linalg for the factor (Bunch-Kaufman pivoted, of K + diag(reg)
    formed outside the timing) and for the substitution (the port's
    factor with identity pivots).  The refined solve has none."""
    from cuclarabel_torch.kkt import ldl

    K, reg, L, Dinv = op["K"], op["reg"], op["L"], op["Dinv"]
    rhs = {1: (op["b"][:, :, None], op["x"][:, :, None].contiguous()),
           2: (op["b2"], op["x2"])}
    out = {}
    for name, R in forms:
        b, x = rhs[R]
        if name == "ldl_factor":
            Kreg = K + torch.diag_embed(reg)
            LDf, pivf = torch.linalg.ldl_factor(Kreg)
            check_library("ldl_factor",
                          torch.linalg.ldl_solve(LDf, pivf, b)[..., 0],
                          op["x"], TOL_LIB_F64)
            out[(name, R)] = lambda Kreg=Kreg: torch.linalg.ldl_factor(Kreg)
        elif name == "ldl_solve":
            LD, piv = ldl_library_operands(L, Dinv)
            out[(name, R)] = checked(
                f"ldl_solve r={R}",
                lambda LD=LD, piv=piv, b=b: torch.linalg.ldl_solve(LD, piv,
                                                                   b), x)
        elif name == "kkt_residual":
            want = ldl.kkt_residual_plain(K, x, b)
            out[(name, R)] = checked(
                f"kkt_residual r={R}",
                lambda b=b, x=x: torch.baddbmm(b, K, x, alpha=-1), want)
    return out


def checked(name, fn, want):
    """fn, after one call (its warm-up) held against the kernel's x."""
    check_library(name, fn(), want, TOL_LIB_F64)
    return fn


def library_ms(fn):
    """One library call's ms.  One that takes more than LIB_SLOW_MS is
    timed once, after its warm-up: cuSOLVER's batched LDL^T through
    torch.linalg loops over the batch on the host and takes seconds."""
    ms = cuda_ms(fn, 1, warmup=0)
    return ms if ms >= LIB_SLOW_MS else cuda_ms(fn, 20)


# the numbers of a kernel form's row kept in the kernels line's by_shape
ROW_KEYS = ("ms", "timed_by", "events_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "blocks_per_sm", "warps_per_sm",
            "registers", "spill_bytes", "form")


def phase_kernel_timing(card):
    """The f64 kernels at N = 76 and each of TIMING_WIDTHS, at N = 104 and
    each of kernel_timing.NONSYM_WIDTHS, and at the PSD paths' (90, 4096)
    and (127, 1) (cuclarabel_torch.kernel_timing: device time, CUDA
    events at B = 4096, plain version, bound, occupancy), each beside its
    library call where it has one, at every shape but (104, 4096) and
    (90, 4096) (LIBRARY_B4096_N: cuSOLVER's LDL^T through torch.linalg
    loops over the batch on the host, a call of seconds at B = 4096,
    timed once).  Returns {kernel: {"B<B>_r<R>" at
    N = 76, "N<N>_B<B>_r<R>" elsewhere: numbers}}."""
    out = {}
    shapes = ([(kt.MAIN_NM, B, kt.F64_FORMS, kt.F64_FORMS, "")
               for B in TIMING_WIDTHS]
              + [(kt.NONSYM_NM, B, kt.NONSYM_FORMS, kt.NONSYM_FORMS, "N104_")
                 for B in kt.NONSYM_WIDTHS]
              + [(nm, B, kt.PSD_FORMS, kt.PSD_FORMS,
                  f"N{sum(nm)}_") for nm, B in kt.PSD_SHAPES
                 if (sum(nm), B) in PSD_TIMED])
    for nm, B, forms, lib_forms, tag in shapes:
        rows, op = kt.time_width(B, forms=forms, nm=nm)
        if B == 4096 and sum(nm) not in LIBRARY_B4096_N:
            lib_forms = ()
        lib = library_calls(op, lib_forms)
        for row in rows:
            fn = lib.get((row["name"], row["R"]))
            row["library_ms"] = library_ms(fn) if fn is not None else None
            print(kt.row_line(card, row) + ", library "
                  + (f"{row['library_ms']:.4f} ms" if fn is not None else
                     "none" if row["name"] == "ldl_solve_refine" else
                     "not timed"), flush=True)
            out.setdefault(row["name"], {})[f"{tag}B{B}_r{row['R']}"] = {
                k: row[k] for k in ROW_KEYS if k in row}
    return out


def time_kernel(card, name, B, N, ms, plain, lib):
    """An f32 kernel's device ms beside its bound, its plain version's ms
    and its library call's ms (a slow library call's warm-up is the
    check against the kernel that its caller made)."""
    plain_ms = cuda_ms(plain, 3)
    lib_ms = library_ms(lib)
    nbytes, ops = kt.work(name, B, N)
    bms, by = kt.bound_ms(nbytes, ops, kt.PEAK_F32_PER_S)
    print(f"[{card}] {name} at N={N} B={B}: device {ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}: {nbytes / 1e9:.3f} GB, "
          f"{ops / 1e9:.3f} GFLOP), plain {plain_ms:.3f} ms, library "
          f"{lib_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bms, "bound_by": by}


def phase_kernel_timing_f32(card, K, b, L, Dinv):
    """The f32 kernels at (76, 4096), with torch.linalg.inv of the f32 K
    (the reference microbenchmark's library baseline,
    scripts/tpu_dd_check.py:96-99) as the factor's library call and
    cuSOLVER's LDL^T substitution through torch.linalg.ldl_solve as the
    solve's, and the f64 kernels ldl_factor and ldl_solve on the same K
    in f64, all four by device time."""
    from cuclarabel_torch.kkt import ldl, ldl_f32

    B, N = b.shape
    LD, piv = ldl_library_operands(L, Dinv)
    b3 = b[:, :, None]
    check_library("ldl_solve_batched",
                  torch.linalg.ldl_solve(LD, piv, b3)[..., 0],
                  ldl_f32.ldl_solve_batched(L, Dinv, b), TOL_LIB_F32)
    K64 = K.double()
    reg0 = torch.zeros_like(b, dtype=torch.float64)
    L64, D64, _ = ldl.ldl_factor(K64, reg0)
    b64 = b.double()
    dev = kt.device_ms({
        ("f32", "ldl_factor_f32_kernel"):
            lambda: ldl_f32.ldl_factor_batched(K),
        ("f32", "ldl_solve_f32_kernel<"):
            lambda: ldl_f32.ldl_solve_batched(L, Dinv, b),
        ("f64", "ldl_factor_kernel"): lambda: ldl.ldl_factor(K64, reg0),
        ("f64", "ldl_solve_kernel<1"): lambda: ldl.ldl_solve(L64, D64, b64)},
        20)
    out = {
        "ldl_factor_batched": time_kernel(
            card, "ldl_factor_batched", B, N,
            dev[("f32", "ldl_factor_f32_kernel")],
            lambda: ldl_f32.ldl_factor_batched_plain(K),
            lambda: torch.linalg.inv(K)),
        "ldl_solve_batched": time_kernel(
            card, "ldl_solve_batched", B, N,
            dev[("f32", "ldl_solve_f32_kernel<")],
            lambda: ldl_f32.ldl_solve_batched_plain(L, Dinv, b),
            lambda: torch.linalg.ldl_solve(LD, piv, b3)),
    }
    for name, kname in (("ldl_factor_batched", "ldl_factor_kernel"),
                        ("ldl_solve_batched", "ldl_solve_kernel<1")):
        out[name]["f64_kernel_ms"] = dev[("f64", kname)]
        print(f"[{card}] {name}: f32 {out[name]['ms']:.4f} ms, the f64 "
              f"kernel on the same K {out[name]['f64_kernel_ms']:.4f} ms "
              "(device time)")
    return out


# ---------------------------------------------------------------------
# the wide forms and the "pallas" path above N = 128 (phase 13)

def hold_wide_to_plain():
    """Every wide form against its plain version on the card at
    WIDE_KERNEL_SHAPES (f64) and WIDE_F32_SHAPES (f32): the factor and the
    substitution bit for bit, the residual and the refined solve's x
    (R = 1, 2; npass = 0, 1, 2; the refined solve in the form
    ldl.refine_form picks) within TOL_WIDE relative, its r bit for bit
    the wide residual's on its x and within TOL_RETURNED_R of b - K x
    summed in twice the precision; a 2-RHS residual and refined solve
    bit for bit two 1-RHS ones; at WIDE_ALONE, three problems' residual
    and refined solve alone (B = 1) bit for bit what they are in the
    batch; x against numpy f64 for the first problems; K with junk above
    its diagonal.  Returns the max abs error per kernel."""
    from cuclarabel_torch.kkt import ldl, ldl_f32

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    errs = {k: 0.0 for k in REPLACES_WIDE}

    def note(name, got, want):
        errs[name] = max(errs[name], float((got - want).abs().max()))

    for n, m, B in WIDE_KERNEL_SHAPES:
        N = n + m
        tag = f"N={N} B={B}"
        Kn, regn = make_kkt(rng, B, n, m, spread=WIDE_SPREAD)
        junk = np.triu(rng.standard_normal(Kn.shape), 1) * JUNK
        K = torch.tensor(Kn + junk, device=dev)
        reg = torch.tensor(regn, device=dev)
        L, Dinv, ok = ldl.ldl_factor(K, reg)
        torch.cuda.synchronize()
        Lp, Dinvp, okp = ldl.ldl_factor_plain(K, reg)
        check(torch.equal(L, Lp) and torch.equal(Dinv, Dinvp)
              and torch.equal(ok, okp) and bool(ok.all()),
              f"wide ldl_factor vs plain at {tag}: {rel(L, Lp):.2e} (bar: "
              "bit for bit)")
        check(bool((L.triu() == 0).all()), f"wide L not strictly lower at "
              f"{tag}")
        note("ldl_factor_wide", L, Lp)
        note("ldl_factor_wide", Dinv, Dinvp)
        c = min(B, NUMPY_CHECK)
        Kreg = Kn[:c] + np.einsum("bi,ij->bij", regn[:c], np.eye(N))
        worst = {}
        for R in (1, 2):
            shape = (B, N) if R == 1 else (B, N, R)
            b = torch.tensor(rng.standard_normal(shape), device=dev)
            bref = b.cpu().numpy()[:c].reshape(c, N, R)
            x = ldl.ldl_solve(L, Dinv, b)
            torch.cuda.synchronize()
            xp = ldl.ldl_solve_plain(L, Dinv, b)
            e = rel(x[:c].cpu(), torch.tensor(np.linalg.solve(
                Kreg, bref)).reshape((c,) + shape[1:]), 1.0)
            check(torch.equal(x, xp) and e < TOL_SOLVE,
                  f"wide ldl_solve r={R} at {tag}: vs plain "
                  f"{rel(x, xp, 1.0):.2e} (bar: bit for bit), vs numpy "
                  f"{e:.2e}")
            note("ldl_solve_wide", x, xp)
            # at a random x, as phase 3 checks the narrow form: at the
            # solution r is rounding noise of terms up to |K| |x|
            x0 = torch.tensor(rng.standard_normal(shape), device=dev)
            r = ldl.kkt_residual(K, x0, b)
            torch.cuda.synchronize()
            rp = ldl.kkt_residual_plain(K, x0, b)
            e = rel(r, rp, 1.0)
            check(e < TOL_WIDE, f"wide kkt_residual r={R} at {tag}: "
                  f"{e:.2e} (bar {TOL_WIDE:g})")
            worst["kkt_residual"] = max(worst.get("kkt_residual", 0.0), e)
            note("kkt_residual_wide", r, rp)
            for npass in (0, 1, 2):
                xr, rr = ldl.ldl_solve_refine(K, L, Dinv, b, npass)
                torch.cuda.synchronize()
                xrp, _ = ldl.ldl_solve_refine_plain(K, L, Dinv, b, npass)
                e1 = rel(xr, xrp, 1.0)
                e3 = float((rr - kkt_residual_exact(K, xr, b)).abs().max())
                e4 = rel(xr[:c].cpu(), torch.tensor(numpy_refine(
                    Kn[:c], Kreg, bref, npass)).reshape((c,) + shape[1:]),
                    1.0)
                check(e1 < TOL_WIDE and e3 < TOL_RETURNED_R
                      and e4 < TOL_SOLVE,
                      f"wide ldl_solve_refine r={R} npass={npass} at {tag}:"
                      f" x vs plain {e1:.2e}, returned r {e3:.2e} from "
                      f"b - K x, x vs numpy {e4:.2e}")
                check(torch.equal(rr, ldl.kkt_residual(K, xr, b)),
                      f"wide ldl_solve_refine r={R} npass={npass} at {tag}:"
                      " its r differs from kkt_residual's (bar: bit for "
                      "bit)")
                worst["ldl_solve_refine"] = max(
                    worst.get("ldl_solve_refine", 0.0), e1)
                note("ldl_solve_refine_wide", xr, xrp)
                if R == 2:
                    for t in range(2):
                        bt = b[:, :, t].contiguous()
                        x1, r1 = ldl.ldl_solve_refine(K, L, Dinv, bt, npass)
                        check(torch.equal(x1, xr[:, :, t])
                              and torch.equal(r1, rr[:, :, t]),
                              f"wide ldl_solve_refine npass={npass} at "
                              f"{tag}: right-hand side {t} of r=2 differs "
                              "from r=1 (bar: bit for bit)")
                if (n, m, B) in WIDE_ALONE and npass == 1:
                    for k in (0, B // 2, B - 1):
                        one = slice(k, k + 1)
                        x1, r1 = ldl.ldl_solve_refine(
                            K[one], L[one], Dinv[one], b[one], npass)
                        check(torch.equal(x1, xr[one])
                              and torch.equal(r1, rr[one])
                              and torch.equal(ldl.kkt_residual(
                                  K[one], x0[one], b[one]), r[one]),
                              f"wide r={R} at {tag}: problem {k} alone "
                              "differs from its batch (bar: bit for bit)")
            if R == 2:
                for t in range(2):
                    check(torch.equal(r[:, :, t], ldl.kkt_residual(
                        K, x0[:, :, t].contiguous(),
                        b[:, :, t].contiguous())),
                          f"wide kkt_residual at {tag}: right-hand side "
                          f"{t} of r=2 differs from r=1 (bar: bit for "
                          "bit)")
        print(f"wide kernels ok at {tag}: factor ({ldl.factor_form(N)}) "
              "and substitution ("
              + "/".join(ldl.solve_form(N, R) for R in (1, 2))
              + ", r = 1/2) bit for bit with plain, " + ", ".join(
                  f"{k} within {v:.3e}" for k, v in worst.items())
              + " of plain (relative); refined solve in the "
              + "/".join(ldl.refine_form(N, R) for R in (1, 2))
              + " form (r = 1/2), its r bit for bit the residual's, r = 2 "
              "bit for bit two r = 1"
              + (", alone bit for bit in the batch"
                 if (n, m, B) in WIDE_ALONE else ""), flush=True)
    for N, B in WIDE_F32_SHAPES:
        tag = f"N={N} B={B}"
        Kn, n, m = make_qd_kkt(rng, B, N)
        K = torch.tensor(Kn, dtype=torch.float32, device=dev)
        Kj = K + torch.triu(torch.tensor(rng.standard_normal(Kn.shape),
                                         dtype=torch.float32, device=dev), 1)
        b = torch.tensor(rng.standard_normal((B, N)), dtype=torch.float32,
                         device=dev)
        L, Dinv = ldl_f32.ldl_factor_batched(Kj)
        x = ldl_f32.ldl_solve_batched(L, Dinv, b)
        torch.cuda.synchronize()
        Lp, Dinvp = ldl_f32.ldl_factor_batched_plain(Kj)
        xp = ldl_f32.ldl_solve_batched_plain(L, Dinv, b)
        Dall = 1.0 / Dinv.double()
        check(torch.equal(L, Lp) and torch.equal(Dinv, Dinvp)
              and torch.equal(x, xp) and bool((L.triu() == 0).all())
              and bool(((Dall > 0).sum(dim=1) == n).all()
                       and ((Dall < 0).sum(dim=1) == m).all()),
              f"wide f32 kernels vs plain at {tag} (bar: bit for bit, "
              f"inertia ({n}, {m}))")
        note("ldl_factor_batched_wide", L, Lp)
        note("ldl_solve_batched_wide", x, xp)
        print(f"wide f32 kernels ok at {tag}: factor "
              f"({ldl.factor_form(N, torch.float32)}) and substitution "
              f"({ldl.solve_form(N, 1, torch.float32)}) bit for bit with "
              f"plain, inertia ({n}, {m})", flush=True)
    return errs


def wide_repeats(card):
    """ROADMAP F14: WIDE_REPEATS solves of the portfolio at nass =
    WIDE_NASS, B = WIDE_REPEAT_B, under "pallas" and under "lu", in this
    process and with no global deterministic setting, give one digest
    each.  Returns {method: digest}."""
    import cuclarabel_torch as ct
    from cuclarabel_torch import solve_digest
    from cuclarabel_torch.problems import portfolio_socp

    check(not torch.are_deterministic_algorithms_enabled(),
          "wide repeats: deterministic algorithms are on")
    A, qs, bs, cones = portfolio_socp(WIDE_NASS, WIDE_REPEAT_B, seed=7)
    out = {}
    for method in ("pallas", "lu"):
        got = [solve_digest.digest(ct.BatchSolver(
            None, qs, A, bs, cones, kkt_solve_method=method).solve())
            for _ in range(WIDE_REPEATS)]
        digests = {d["sha256"] for d in got}
        check(len(digests) == 1, f"wide repeats under {method}: "
              f"{len(digests)} digests in {WIDE_REPEATS} solves (F14)")
        out[method] = got[0]["sha256"]
        print(f"[{card}] wide B={WIDE_REPEAT_B} under {method}: "
              f"{WIDE_REPEATS} solves, one digest {out[method][:16]}, "
              f"iterations sum {sum(got[0]['iterations'])}", flush=True)
    return out


def wide_kernels_only(launches, path):
    """A path above N = 128 launched the wide forms and no narrow one."""
    narrow = {k: v for k, v in launches.items()
              if k != "segment_sum" and "_wide/" not in k}
    check(not narrow, f"{path}: narrow forms launched above N = 128: "
          f"{narrow}")


def first_call_ms(name, fn, pick, want, tol):
    """A library call's ms: its first call timed by CUDA events and its x
    (pick(result)) held against the kernel's; a call under LIB_SLOW_MS is
    timed again over 20 calls.  cuSOLVER's LDL^T through torch.linalg
    loops over the batch on the host, so its first call is its time."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    check_library(name, pick(out), want, tol)
    ms = t0.elapsed_time(t1)
    return ms if ms >= LIB_SLOW_MS else cuda_ms(fn, 20)


def wide_library_ms(op, B):
    """{(name, R): library ms} of the wide timing at width B: baddbmm for
    the residual; at B = WIDE_LIBRARY_B also cuSOLVER's LDL^T through
    torch.linalg for the factor (of K + diag(reg), pivoted) and the
    substitution (the port's factor, identity pivots), f64 and f32, each
    checked against the kernel's x."""
    out = {key: library_ms(fn) for key, fn in library_calls(
        op, [("kkt_residual", 1), ("kkt_residual", 2)]).items()}
    if B != WIDE_LIBRARY_B:
        return out
    from cuclarabel_torch.kkt import ldl_f32

    K, reg, b = op["K"], op["reg"], op["b"][:, :, None]
    # the factor's time, without the solve that checks it
    out[("ldl_factor", 1)] = first_call_ms(
        "ldl_factor", lambda: torch.linalg.ldl_factor(
            K + torch.diag_embed(reg)), lambda f: torch.linalg.ldl_solve(
                *f, b)[..., 0], op["x"], TOL_LIB_F64)
    LD, piv = ldl_library_operands(op["L"], op["Dinv"])
    for R, (rhs, x) in {1: (b, op["x"][:, :, None]),
                        2: (op["b2"], op["x2"])}.items():
        out[("ldl_solve", R)] = first_call_ms(
            f"ldl_solve r={R}", lambda rhs=rhs: torch.linalg.ldl_solve(
                LD, piv, rhs), lambda y: y, x, TOL_LIB_F64)
    # the f32 calls on a well-conditioned K of the same shape (the f64
    # K's Hs spread of 10^(+-4) is beyond f32 without pivoting)
    N = op["b"].shape[1]
    Kq, _, _ = make_qd_kkt(np.random.default_rng(15), B, N)
    Kf = torch.tensor(Kq, dtype=torch.float32, device=b.device)
    bf = op["bf"]
    Lf, Df = ldl_f32.ldl_factor_batched(Kf)
    xf = ldl_f32.ldl_solve_batched(Lf, Df, bf)
    out[("ldl_factor_batched", 1)] = first_call_ms(
        "ldl_factor_batched", lambda: torch.linalg.ldl_factor(Kf),
        lambda f: torch.linalg.ldl_solve(*f, bf[:, :, None])[..., 0], xf,
        TOL_LIB_F32)
    LDf, pivf = ldl_library_operands(Lf, Df)
    out[("ldl_solve_batched", 1)] = first_call_ms(
        "ldl_solve_batched", lambda: torch.linalg.ldl_solve(
            LDf, pivf, bf[:, :, None]), lambda y: y[..., 0], xf, TOL_LIB_F32)
    return out


def wide_kernel_timing(card):
    """Each wide form at kernel_timing.WIDE_SHAPES ((148, 4096), (148, 1),
    (292, 256)): device ms per launch, bound, plain ms, occupancy and
    registers (kernel_timing.time_width), beside its library call's ms
    (wide_library_ms) or null.  Returns {kernel: {"N<N>_B<B>_r<R>":
    numbers}} under the wide names."""
    out = {}
    for nm, B in kt.WIDE_SHAPES:
        rows, op = kt.time_width(B, forms=kt.WIDE_FORMS, nm=nm)
        lib = wide_library_ms(op, B)
        for row in rows:
            row["library_ms"] = lib.get((row["name"], row["R"]))
            print(kt.row_line(card, row) + ", library "
                  + (f"{row['library_ms']:.4f} ms"
                     if row["library_ms"] is not None else
                     "none" if row["name"] == "ldl_solve_refine" else
                     "not timed"), flush=True)
            out.setdefault(f"{row['name']}_wide", {})[
                f"N{row['N']}_B{B}_r{row['R']}"] = {
                    k: row[k] for k in ROW_KEYS if k in row}
    return out


def phase_wide(card):
    """The "pallas" path above N = 128 on the card (phase 13): the wide
    forms against plain (hold_wide_to_plain); then, each driven with the
    counters set to 0 just before it and read just after, BatchSolver on
    problems.portfolio_socp(64, 4096, 7) (N = 148) under explicit
    "pallas", staged (the default at B = 4096) and plain: every problem
    SOLVED, staged equal to plain in status and iterations (compare_staged),
    the first CPU_CHECK problems within 1e-7 of the port's CPU solve; the
    Solver on problem 0 (SOLVED, the CPU's iterations); nass = 128
    (N = 292) at B = 256: every problem SOLVED; the f32 entry points at
    (148, 4096).  The same B = 4096 batch under "lu": the per-problem
    difference in iterations from "pallas" printed, and warm problems/s
    of both (staged) over WIDE_REPS solves in turns; then the wide
    kernels' times.  Returns (launches by path, errors, times, record)."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import portfolio_socp

    steps, mark = {}, [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        steps[name] = round(now - mark[0], 1)
        mark[0] = now

    errs = hold_wide_to_plain()
    step("kernels_vs_plain")
    paths, rec, runs = {}, {}, {}
    A, qs, bs, cones = portfolio_socp(WIDE_NASS, WIDE_B, seed=7)
    N = qs.shape[1] + bs.shape[1]
    for path, settings in (("wide_B4096", {}),
                           ("wide_B4096_plain", {"batch_compaction": 0.0})):
        def drive():
            t0 = time.perf_counter()
            solver = ct.BatchSolver(None, qs, A, bs, cones,
                                    kkt_solve_method="pallas", **settings)
            return solver, solver.solve(), time.perf_counter() - t0

        (solver, sols, cold), paths[path] = counted(path, drive)
        check(all(s.status == ct.SolverStatus.SOLVED for s in sols),
              f"{path}: not all SOLVED: "
              f"{collections.Counter(s.status.name for s in sols)}")
        check(all(np.isfinite(s.x).all() for s in sols),
              f"{path}: non-finite x")
        for key in ("ldl_factor_wide/r1", "ldl_solve_refine_wide/r1",
                    "ldl_solve_refine_wide/r2"):
            check(paths[path].get(key, 0) > 0, f"{path}: {key} never "
                  "launched")
        wide_kernels_only(paths[path], path)
        runs[path] = (solver, sols, cold)
        print(f"[{card}] {path} (N = {N}): all SOLVED, first solve "
              f"{cold:.2f} s", flush=True)
    check(runs["wide_B4096"][0].last_compaction["remainder"] > 0,
          "wide_B4096: stage 2 did not run")
    step("batch_pallas")
    rec["staged_vs_plain"] = compare_staged(
        card, runs["wide_B4096"][1], runs["wide_B4096_plain"][1],
        what="wide_B4096",
        width_ops=lambda: width_dependent_ops(nass=WIDE_NASS))

    sols = runs["wide_B4096"][1]
    cpu = ct.BatchSolver(None, qs[:CPU_CHECK], A, bs[:CPU_CHECK], cones,
                         device="cpu", kkt_solve_method="pallas").solve()
    worst_x = worst_obj = 0.0
    for g, c in zip(sols[:CPU_CHECK], cpu):
        check(g.status == c.status, f"wide: status {g.status.name} vs CPU "
              f"{c.status.name}")
        worst_x = max(worst_x, float(np.abs(g.x - c.x).max())
                      / max(float(np.abs(c.x).max()), 1.0))
        worst_obj = max(worst_obj, abs(g.obj_val - c.obj_val)
                        / abs(c.obj_val))
    check(worst_x <= TOL_X_SINGLE and worst_obj <= TOL_OBJ,
          f"wide: the first {CPU_CHECK} problems: x {worst_x:.2e}, "
          f"objective {worst_obj:.2e} from the CPU solve")
    its = [(g.iterations, c.iterations) for g, c in
           zip(sols[:CPU_CHECK], cpu)]
    step("cpu_check")
    print(f"[{card}] wide: the first {CPU_CHECK} problems within "
          f"{worst_x:.3e} (x) and {worst_obj:.3e} (objective) of the CPU "
          f"solve; iterations (card, CPU) {its}", flush=True)

    lu = ct.BatchSolver(None, qs, A, bs, cones, kkt_solve_method="lu")
    t0 = time.perf_counter()
    lu_sols = lu.solve()
    lu_cold = time.perf_counter() - t0
    check(all(s.status == ct.SolverStatus.SOLVED for s in lu_sols),
          "wide: the lu batch not all SOLVED")
    diff = collections.Counter(p.iterations - q.iterations
                               for p, q in zip(sols, lu_sols))
    far = [i for i, (p, q) in enumerate(zip(sols, lu_sols))
           if abs(p.iterations - q.iterations) > 1]
    print(f"[{card}] wide_B4096 iterations, pallas minus lu: "
          f"{dict(sorted(diff.items()))} (problems more than one off: "
          f"{far[:20]}{' ...' if len(far) > 20 else ''}); lu first solve "
          f"{lu_cold:.2f} s", flush=True)
    rec["iterations_pallas_minus_lu"] = dict(sorted(diff.items()))
    rec["more_than_one_off"] = far

    step("batch_lu")
    solver = runs["wide_B4096"][0]
    ms = {"pallas": [], "lu": []}
    for r in range(WIDE_REPS):
        for name in (("pallas", "lu") if r % 2 == 0 else ("lu", "pallas")):
            ms[name].append(solve_ms(solver if name == "pallas" else lu, qs,
                                     r))
    rate = {k: [WIDE_B * 1e3 / t for t in v] for k, v in ms.items()}
    rec["problems_per_s"] = {k: {"median": float(np.median(v)),
                                 "all": v} for k, v in rate.items()}
    print(f"[{card}] wide_B4096 staged, warm problems/s (median of "
          f"{WIDE_REPS}, in turns): pallas "
          f"{np.median(rate['pallas']):.1f} (spread "
          f"{min(rate['pallas']):.1f}-{max(rate['pallas']):.1f}), lu "
          f"{np.median(rate['lu']):.1f} (spread {min(rate['lu']):.1f}-"
          f"{max(rate['lu']):.1f})", flush=True)
    del lu, lu_sols, runs
    step("problems_per_s")

    def drive_solver():
        s = ct.Solver(None, qs[0], A, bs[0], cones,
                      kkt_solve_method="pallas")
        t0 = time.perf_counter()
        return s, s.solve(), (time.perf_counter() - t0) * 1e3

    (s1, got, one_ms), paths["wide_solver"] = counted("wide_solver",
                                                     drive_solver)
    want = ct.Solver(None, qs[0], A, bs[0], cones, device="cpu",
                     kkt_solve_method="pallas").solve()
    err = abs(got.obj_val - want.obj_val) / abs(want.obj_val)
    check(got.status == ct.SolverStatus.SOLVED and err <= TOL_OBJ
          and s1.get_info()["linear_solver"]["method"] == "pallas",
          f"wide Solver: {got.status.name}, objective {err:.2e} from the "
          "CPU's")
    check(paths["wide_solver"].get("ldl_factor_wide/r1", 0) > 0,
          "wide Solver: ldl_factor_wide never launched")
    wide_kernels_only(paths["wide_solver"], "wide_solver")
    print(f"[{card}] wide Solver (N = {N}, pallas): SOLVED in "
          f"{got.iterations} iterations (CPU {want.iterations}), objective "
          f"{err:.2e} from the CPU's, {one_ms:.1f} ms", flush=True)
    rec["solver"] = {"iterations": got.iterations,
                     "cpu_iterations": want.iterations, "ms": one_ms}
    step("solver")
    rec["repeats"] = wide_repeats(card)
    step("repeats")

    nass, B = WIDE_BIG
    Ab, qb, bb, cb = portfolio_socp(nass, B, seed=7)

    def drive_big():
        t0 = time.perf_counter()
        big = ct.BatchSolver(None, qb, Ab, bb, cb, kkt_solve_method="pallas")
        return big.solve(), time.perf_counter() - t0

    (big, big_s), paths["wide_B256_n292"] = counted("wide_B256_n292",
                                                    drive_big)
    check(all(s.status == ct.SolverStatus.SOLVED for s in big),
          f"wide nass={nass} B={B}: not all SOLVED: "
          f"{collections.Counter(s.status.name for s in big)}")
    wide_kernels_only(paths["wide_B256_n292"], "wide_B256_n292")
    Nb = qb.shape[1] + bb.shape[1]
    print(f"[{card}] wide nass={nass} (N = {Nb}) B={B}: all SOLVED, "
          f"iterations mean {np.mean([s.iterations for s in big]):.2f}, "
          f"first solve {big_s:.2f} s", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    Kn, _, _ = make_qd_kkt(rng, WIDE_B, N)
    bn = rng.standard_normal((WIDE_B, N))
    K32 = torch.tensor(Kn, dtype=torch.float32, device=dev)
    b32 = torch.tensor(bn, dtype=torch.float32, device=dev)

    def drive_f32():
        L, Dinv = ct.ldl_factor_batched(K32)
        return ct.ldl_solve_batched(L, Dinv, b32)

    x32, paths["wide_f32"] = counted("wide_f32", drive_f32)
    wide_kernels_only(paths["wide_f32"], "wide_f32")
    res = np.abs(np.einsum("bij,bj->bi", Kn[:F32_CHECK],
                           x32[:F32_CHECK].double().cpu().numpy())
                 - bn[:F32_CHECK]).max()
    check(res < 1e-3, f"wide f32 path: residual {res:.2e} (bar 1e-3)")
    print(f"wide f32 path at N={N} B={WIDE_B}: max |K x - b| {res:.2e}")
    step("n292_and_f32")
    times = wide_kernel_timing(card)
    step("kernel_timing")
    rec["step_seconds"] = steps
    print(f"wide phase, seconds by step: {json.dumps(steps)}", flush=True)
    return paths, errs, times, rec


# ---------------------------------------------------------------------
# several cards, the modeling layer and precompile (phases 9-12)

class _Iterations:
    """What sparse_row reads of a solver: its iterations."""

    def __init__(self, sol):
        self.raw = {"iterations": [sol.iterations]}


def phase_sharded(card):
    """ShardedSolver on one card, driven with the LDL^T kernels' counters
    set to 0 just before it and read just after (the block-arrow KKT
    runs none of them: its products are cuBLAS's, its saddle inverse
    plain torch): problems.box_budget_qp at SHARDED_QP (A 2.1 GB in
    f64): SOLVED, the optimality conditions recomputed on the host
    within 1e-7, a second solve bitwise equal; its record (cold and warm
    ms, loop passes, host syncs and launches per pass, idle share, peak
    memory, the saddle inverses kept); then problems.sharded_socp()
    with the CPU's iterations.  Returns (launches by path, record, the
    QP's data and one-card result for phase_multi)."""
    import scipy.sparse as sp

    import cuclarabel_torch as ct
    from cuclarabel_torch import problems
    from cuclarabel_torch.kkt import arrow

    paths = {}
    n, m_in, seed = SHARDED_QP
    t0 = time.perf_counter()
    data = problems.box_budget_qp(n, m_in, seed)
    make_s = time.perf_counter() - t0
    P, q, A, b, cones = data

    def drive():
        arrow.SADDLE_INVERSES.clear()
        return cold(lambda: (lambda s: (s, s.solve()))(
            ct.ShardedSolver(P, q, A, b, cones)))

    ((solver, sol), cold_ms, peak), paths["sharded_qp"] = counted(
        "sharded_qp", drive)
    inverses = dict(arrow.SADDLE_INVERSES)
    check(solver.device.type == "cuda" and len(solver._dev["A"].slabs) == 1,
          "ShardedSolver: not on one CUDA device")
    check(sol.status == ct.SolverStatus.SOLVED,
          f"sharded QP: {sol.status.name}")
    cond = kkt_conditions(sp.triu(sp.csr_matrix(P)), q, A, b, sol, zero=1)
    check(max(cond.values()) <= TOL_KKT,
          f"sharded QP: host-checked optimality {cond}")
    t0 = time.perf_counter()
    again = solver.solve()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(all(np.array_equal(getattr(sol, f), getattr(again, f))
              for f in ("x", "s", "z"))
          and sol.iterations == again.iterations,
          "sharded QP: a second solve is not bitwise equal")
    _, passes, syncs = host_syncs(solver.solve)

    def rerun(r):
        solver.update_data(q=q * (1.0 + 1e-9 * r))
        solver.solve()

    print(f"[{card}] sharded QP n={n} m={m_in + 1}: A {A.nbytes / 1e9:.2f}"
          f" GB, data made in {make_s:.1f} s; SOLVED in {sol.iterations} "
          f"iterations, objective {sol.obj_val:.12g}, r_prim "
          f"{sol.r_prim:.2e}, r_dual {sol.r_dual:.2e}, host-checked "
          + ", ".join(f"{k} {v:.2e}" for k, v in cond.items())
          + f"; a second solve bitwise equal; saddle inverses kept "
          f"{json.dumps(inverses, sort_keys=True)}", flush=True)
    rec = sparse_row(card, "sharded_qp", _Iterations(sol), cold_ms, rerun,
                     peak, None, measured=(warm_ms, passes, syncs))
    rec.update(kkt_check=cond, data_seconds=make_s, saddle_inverses=inverses,
               a_bytes=A.nbytes, objective=sol.obj_val)
    del solver

    # the sharded_socp problem against the CPU
    small = problems.sharded_socp()
    got = ct.ShardedSolver(*small).solve()
    want = ct.ShardedSolver(*small, device="cpu").solve()
    check(got.status == want.status == ct.SolverStatus.SOLVED
          and got.iterations == want.iterations
          and rel(torch.tensor(got.obj_val), torch.tensor(want.obj_val),
                  1.0) <= TOL_OBJ,
          f"sharded_socp on the card: {got.status.name} in "
          f"{got.iterations} iterations, objective {got.obj_val} (CPU: "
          f"{want.status.name}, {want.iterations}, {want.obj_val})")
    print(f"[{card}] sharded_socp (n = 40, m = 56): SOLVED in "
          f"{got.iterations} iterations, the CPU's; objective "
          f"{got.obj_val:.12g} (CPU {want.obj_val:.12g})", flush=True)
    rec["sharded_socp"] = {"iterations": got.iterations,
                           "objective": got.obj_val,
                           "cpu_objective": want.obj_val}
    return paths, rec, (data, sol.obj_val, peak)


def phase_multi(card, qp):
    """With 2 or more cards: the QP of phase_sharded at n_devices = the
    card count (objective within 1e-8 of one card's; each card's peak
    memory beside its share of A), then BatchSolver on the portfolio at
    B = DP_BATCH over every card, driven with the counters set to 0 just
    before it and read just after (K1-K4 launched on every card, each
    slab bitwise equal to a one-card batch of it on its card), and warm
    problems/s at 1, 2, 4 ... cards (median of DP_REPS).  With one card
    it says so and returns no path."""
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems
    from cuclarabel_torch.kkt import ldl

    count = torch.cuda.device_count()
    if count < 2:
        why = (f"this host has {count} CUDA device; the multi-card checks "
               "(ShardedSolver over several cards, the data-parallel "
               "batch) need 2 or more")
        print(f"[{card}] multi-card phase not run: {why}", flush=True)
        return {}, {"ran": False, "reason": why}
    paths, rec = {}, {"ran": True, "cards": count}
    (P, q, A, b, cones), one_obj, one_peak = qp
    for i in range(count):
        torch.cuda.reset_peak_memory_stats(i)

    def drive_qp():
        solver = ct.ShardedSolver(P, q, A, b, cones, n_devices=count)
        t0 = time.perf_counter()
        sol = solver.solve()
        return solver, sol, (time.perf_counter() - t0) * 1e3

    (solver, sol, ms), paths["sharded_qp_multi"] = counted(
        "sharded_qp_multi", drive_qp)
    check([a.device.index for a in solver._dev["A"].slabs]
          == list(range(count)), "sharded QP: slabs not one per card")
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(count)]
    err = abs(sol.obj_val - one_obj) / max(1.0, abs(one_obj))
    check(sol.status == ct.SolverStatus.SOLVED and err <= TOL_SHARDED_OBJ,
          f"sharded QP over {count} cards: {sol.status.name}, objective "
          f"{sol.obj_val} against one card's {one_obj}")
    slab = A.nbytes / count
    # a card holds its slab of A and the temporary A' D^-1 of one
    # factorization; the first card also the vectors and the saddle
    # that one card held beside A and its temporary
    home_extra = max(0.0, one_peak - 2.0 * A.nbytes)
    bound = [2.2 * slab + (home_extra if i == 0 else 0.0) + 64e6
             for i in range(count)]
    check(all(p <= bd for p, bd in zip(peaks, bound)),
          f"sharded QP: peak memory per card {peaks} above {bound}")
    print(f"[{card}] sharded QP over {count} cards: SOLVED in "
          f"{sol.iterations} iterations, objective within {err:.2e} of one "
          f"card's, solve {ms:.1f} ms; peak memory per card "
          + ", ".join(f"{p / 1e9:.2f} GB ({p / slab:.2f} x its slab of A)"
                      for p in peaks)
          + f" (one card: {one_peak / 1e9:.2f} GB)", flush=True)
    rec["sharded_qp"] = {"iterations": sol.iterations, "obj_rel_err": err,
                         "solve_ms": ms, "peak_bytes": peaks,
                         "one_card_peak_bytes": one_peak}
    del solver

    Ab, qs, bs, pcones = problems.portfolio_socp(NASS, DP_BATCH, seed=7)
    dp = ct.BatchSolver(None, qs, Ab, bs, pcones, n_devices=count)
    dp.solve()
    torch.cuda.synchronize()
    ldl.reset_counts()
    (got, _), paths["batch_dp"] = counted("batch_dp",
                                          lambda: (dp.solve(), None))
    by_card = {k: dict(v) for k, v in ldl.LAUNCHES.by_device.items()}
    for i in range(count):
        launched = by_card.get(f"cuda:{i}", {})
        check(all(launched.get(f"{k}/r1", 0) > 0 for k in (
            "ldl_factor", "ldl_solve_refine")),
            f"batch over {count} cards: cuda:{i} launched {launched}")
    w = DP_BATCH // count
    for i in range(count):
        one = ct.BatchSolver(None, qs[i * w:(i + 1) * w], Ab,
                             bs[i * w:(i + 1) * w], pcones,
                             device=f"cuda:{i}",
                             batch_compaction=0.0).solve()
        check(all(g.status == o.status and g.iterations == o.iterations
                  and all(np.array_equal(getattr(g, f), getattr(o, f))
                          for f in ("x", "s", "z"))
                  for g, o in zip(got[i * w:(i + 1) * w], one)),
              f"batch over {count} cards: slab {i} differs from a "
              "one-card batch of it")
    check(all(s.status == ct.SolverStatus.SOLVED for s in got),
          "batch over several cards: not every problem SOLVED")
    rates = {}
    widths = sorted({k for k in (1, 2, 4, 8) if k <= count} | {count})
    for k in widths:
        solver = ct.BatchSolver(None, qs, Ab, bs, pcones, n_devices=k,
                                batch_compaction=0.0)
        solver.solve()
        walls = []
        for _ in range(DP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.solve()
            walls.append(time.perf_counter() - t0)
        rates[k] = {"problems_per_s_median": DP_BATCH / float(
            np.median(walls)), "problems_per_s": [DP_BATCH / t
                                                  for t in walls]}
    print(f"[{card}] batch B={DP_BATCH} over {count} cards: every slab "
          f"bitwise equal to a one-card batch of it; launches by card "
          f"{json.dumps(by_card, sort_keys=True)}; warm problems/s "
          + ", ".join(f"{k} card(s) {v['problems_per_s_median']:.1f} "
                      f"(spread {min(v['problems_per_s']):.1f} to "
                      f"{max(v['problems_per_s']):.1f})"
                      for k, v in rates.items()), flush=True)
    rec["batch_dp"] = {"launches_by_card": by_card, "rates": rates}
    return paths, rec


def phase_modeling(card):
    """The modeling layer on the card, driven with the counters set to 0
    just before it and read just after: problems.portfolio_model(32)
    solved with the dense backend (Solver, the f64 kernels at N = 76),
    bitwise equal to Solver on the same data, and with the sparse
    backend (SparseSolver), SOLVED within 1e-7 of the dense objective."""
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems

    paths = {}

    def drive():
        model, x, data = problems.portfolio_model(NASS)
        t0 = time.perf_counter()
        sol = model.solve()
        return model, x, data, sol, (time.perf_counter() - t0) * 1e3

    (model, x, (A, q, b, cones), sol, dense_ms), paths["modeling"] = \
        counted("modeling", drive)
    check(isinstance(model.solver, ct.Solver)
          and model.solver.device.type == "cuda",
          "Model: the dense backend is not a Solver on the card")
    want = ct.Solver(None, q, A, b, cones).solve()
    check(sol.status == ct.SolverStatus.SOLVED
          and np.array_equal(x.value, want.x)
          and sol.iterations == want.iterations,
          f"Model (dense): {sol.status.name}, not Solver's result")
    sparse_model = problems.portfolio_model(NASS)[0]
    t0 = time.perf_counter()
    ssol = sparse_model.solve(backend="sparse")
    sparse_ms = (time.perf_counter() - t0) * 1e3
    check(isinstance(sparse_model.solver, ct.SparseSolver)
          and sparse_model.solver.device.type == "cuda",
          "Model: the sparse backend is not a SparseSolver on the card")
    err = abs(ssol.obj_val - sol.obj_val) / max(1.0, abs(sol.obj_val))
    check(ssol.status == ct.SolverStatus.SOLVED and err <= TOL_OBJ,
          f"Model (sparse): {ssol.status.name}, objective {ssol.obj_val} "
          f"against the dense {sol.obj_val}")
    print(f"[{card}] Model of the portfolio (n = 33, m = 43): dense SOLVED "
          f"in {sol.iterations} iterations ({dense_ms:.1f} ms, bitwise "
          f"Solver's), sparse SOLVED in {ssol.iterations} ({sparse_ms:.1f} "
          f"ms, objective within {err:.2e})", flush=True)
    return paths, {"dense_ms": dense_ms, "sparse_ms": sparse_ms,
                   "iterations": [sol.iterations, ssol.iterations],
                   "objective": sol.obj_val, "sparse_rel_err": err}


PRECOMPILE_CODE = """
import json, time
t0 = time.perf_counter()
import torch
import cuclarabel_torch as ct
t1 = time.perf_counter()
first = ct.precompile()
again = ct.precompile()
print(json.dumps({"import_s": t1 - t0, "first": first, "again": again}))
"""


def phase_precompile(card):
    """precompile() in a fresh process (the kernel library built in
    build/ already): each family's seconds on the first call, which pays
    the process's one-time costs, and on a second call in the same
    process.  The first family's is the port's first-solve latency."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", PRECOMPILE_CODE], cwd=root,
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"precompile: exit {out.returncode}: "
          f"{out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    families = ("lp", "qp", "socp", "exp", "pow", "genpow", "sdp")
    check(set(rec["first"]) == set(families) == set(rec["again"]),
          f"precompile: families {sorted(rec['first'])}")
    print(f"[{card}] precompile in a fresh process: import "
          f"{rec['import_s']:.2f} s; first call "
          + ", ".join(f"{k} {v:.3f} s" for k, v in rec["first"].items())
          + "; second call "
          + ", ".join(f"{k} {v:.3f} s" for k, v in rec["again"].items()),
          flush=True)
    return rec


def wide_forms(paths, name="ldl_solve_refine_wide"):
    """A wide f64 kernel's launches on the wide paths by form ("shared":
    the problem's triangle in shared memory, "streaming") and R, from
    each path's N (WIDE_PATH_N) and the form its launcher picks there
    (ldl.factor_form, solve_form, refine_form)."""
    from cuclarabel_torch.kkt import ldl

    form = {"ldl_factor_wide": lambda N, R: ldl.factor_form(N),
            "ldl_solve_wide": ldl.solve_form,
            "ldl_solve_refine_wide": ldl.refine_form}[name]
    out = collections.Counter()
    for path, N in WIDE_PATH_N.items():
        for R in (1, 2):
            out[f"{form(N, R)}/r{R}"] += paths.get(path, {}).get(
                f"{name}/r{R}", 0)
    return dict(out)


def kernel_entries(paths, errs, times):
    """The `kernels` JSON rows: one per kernel function, its launches
    summed over the main paths' runs and split by path and by number of
    right-hand sides; an f64 kernel's times at (76, 4096) with R = 1, a
    wide form's at (148, 4096), and under `by_shape` at every timed
    width and R.  `ms` is device time per launch throughout."""
    rows = []
    for name, replaces, source in (
            [(k, v, SOURCE) for k, v in REPLACES.items()]
            + [(k, v, SOURCE_F32) for k, v in REPLACES_F32.items()]
            + [(k, v, SOURCE_PROBES) for k, v in REPLACES_PROBES.items()]
            + [(k, v, SOURCE_WIDE) for k, v in REPLACES_WIDE.items()]
            + [(k, v, SOURCE_SEGSUM) for k, v in REPLACES_SEGSUM.items()]):
        per_path = {path: sum(v for kk, v in launches.items()
                              if kk.split("/")[0] == name)
                    for path, launches in paths.items()}
        check(sum(per_path.values()) > 0,
              f"kernel {name} never launched on a main path")
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
            entry["launches_by_form"] = {
                f"r{R}": sum(launches.get(f"{name}/r{R}", 0)
                             for launches in paths.values())
                for R in (1, 2)}
        if name in WIDE_FORM_KERNELS:
            entry["launches_by_form"] = wide_forms(paths, name)
        entry.update(launches=sum(per_path.values()),
                     launches_per_path=per_path, max_abs_err=errs[name])
        t = times[name]
        # an f64 kernel: (76, 4096), R = 1, up front; a wide form:
        # (148, 4096), R = 1
        front = next((k for k in ("B4096_r1", "N148_B4096_r1") if k in t),
                     None)
        if front is not None:
            entry.update({k: t[front][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                by_shape=t)
        else:
            entry.update(t)
        rows.append(entry)
    return rows


def run_last_phases(card, timed):
    """Phases 9-12: sharded, multi, modeling, precompile.  Returns
    (launches by path, their records)."""
    paths, last = {}, {}
    sharded_paths, last["sharded"], qp = timed("sharded", phase_sharded,
                                               card)
    paths.update(sharded_paths)
    multi_paths, last["multi"] = timed("multi", phase_multi, card, qp)
    paths.update(multi_paths)
    del qp
    modeling_paths, last["modeling"] = timed("modeling", phase_modeling,
                                             card)
    paths.update(modeling_paths)
    last["precompile"] = timed("precompile", phase_precompile, card)
    return paths, last


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.device_count()} device(s)")
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {seconds[name]} s", flush=True)
        return out

    if sys.argv[1:] == ["--wide"]:
        # the build and the "pallas" path above N = 128 alone
        timed("build", phase_build)
        paths, errs, times, rec = timed("wide", phase_wide, card)
        print(json.dumps({"wide": rec, "phase_seconds": seconds}))
        print(json.dumps({"kernels": [
            dict(name=k, launches=sum(v for p in paths.values()
                                      for kk, v in p.items()
                                      if kk.split("/")[0] == k),
                 max_abs_err=errs[k], **times[k].get("N148_B4096_r1", {}))
            for k in REPLACES_WIDE],
            "launches_by_form": {k: wide_forms(paths, k)
                                 for k in WIDE_FORM_KERNELS}}))
        return 0
    if sys.argv[1:] == ["--multi"]:
        # the phases that need several cards, and what they compare with
        timed("build", phase_build)
        last = {}
        _, last["sharded"], qp = timed("sharded", phase_sharded, card)
        _, last["multi"] = timed("multi", phase_multi, card, qp)
        print(json.dumps({"several_cards": last, "phase_seconds": seconds}))
        return 0
    timed("build", phase_build)
    errs = timed("kernels", phase_kernels)
    errs.update(timed("kernels_f32", phase_kernels_f32))
    errs.update(timed("probes", phase_probes))
    seg_errs, seg_times = timed("segment_sum", phase_segment_sum, card)
    errs.update(seg_errs)
    runs, paths, staged = timed("main", phase_main, card)
    paths["batch_B256_warm"], warm = timed("warm", phase_warm, card, runs)
    paths["solver"], solver_times = timed("solver", phase_solver, card)
    solver_times["phases_ms"] = timed("solver_backends",
                                      phase_solver_backends, card)
    paths["f32"], f32_data = timed("f32", phase_f32_path)
    paths["probes"], probe_times = timed("probes_path", phase_probes_path,
                                         card)
    # the kernel timing before the profiled solves: after a session of
    # 10^4-10^5 launches the profiler has been seen to drop the events
    # of later sessions (kernel_timing.device_ms then times by CUDA
    # events, and a solve's busy share is not measured)
    times = timed("kernel_timing", phase_kernel_timing, card)
    times.update(timed("kernel_timing_f32", phase_kernel_timing_f32, card,
                       *f32_data))
    wide_paths, wide_errs, wide_times, wide = timed("wide", phase_wide, card)
    paths.update(wide_paths)
    errs.update(wide_errs)
    times.update(wide_times)
    batch_times = timed("timing", phase_timing, card, runs)
    nonsym_paths, nonsym = timed("nonsym", phase_nonsym, card)
    paths.update(nonsym_paths)
    psd_paths, psd = timed("psd", phase_psd, card)
    paths.update(psd_paths)
    sparse_paths, sparse = timed("sparse", phase_sparse, card)
    paths.update(sparse_paths)
    last_paths, last = run_last_phases(card, timed)
    paths.update(last_paths)
    sparse["phase_seconds"] = seconds
    times.update(probe_times)
    times.update(seg_times)
    print(json.dumps({"solver_n76": solver_times}))
    print(json.dumps({"batch_B4096": {"staged_vs_plain": staged,
                                      "timing": batch_times},
                      "batch_B256_warm": warm}))
    print(json.dumps({"nonsymmetric": nonsym}))
    print(json.dumps({"psd": psd}))
    print(json.dumps({"sparse": sparse}))
    print(json.dumps({"several_cards_modeling_precompile": last}))
    print(json.dumps({"wide": wide}))
    print(json.dumps({"kernels": kernel_entries(paths, errs, times)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
