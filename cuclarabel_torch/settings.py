"""User-facing solver settings.

A copy of `cuclarabel_tpu/settings.py` (the JAX package is the
reference; the port imports nothing from it) so that the same fields,
defaults and validation hold on both sides and a reference `Settings`
dict loads here unchanged (`interop.settings_from_reference`).

Parity with the reference `Settings{T}` kwdef struct
(`src/settings.jl:70-148`), plus the KKT backend knobs.  The field
comments below are the JAX package's and describe its TPU measurements;
in this package:

  * `kkt_solve_method="pallas"` selects the hand-written Hopper LDL^T
    kernels (`kkt/ldl.py`; `csrc/ldl.cu` for KKT dims N <= 128,
    `csrc/ldl_wide.cu` above) at any N; the name stays for parity with
    the reference `Settings`.  "auto" picks "pallas" for N <= 128 and
    "lu" (f64 `torch.linalg.lu_factor`) above; "qr" and "inverse" take `torch.linalg`'s QR and inverse
    (`kkt/dense.py`).
  * `kkt_factor_precision="float32"` factors in f32 under "lu", "qr"
    and "inverse" and refines in f64, as in the reference; "pallas"
    factors in f64 whatever it says, as the reference's "pallas" does.
  * `host_solve` is accepted and has no effect: the port never moves a
    solve off the device it was given.
  * `batch_compaction` resolves as in the reference: auto is 0.9 at
    B >= batch_compaction_min_batch and 0 below, and BatchSolver runs
    staged compaction (`parallel/batch.py`, without the power-of-two
    padding of the field comment) whenever it is > 0.
"""

import dataclasses
from typing import Optional
import numpy as np

_F64_EPS = float(np.finfo(np.float64).eps)


@dataclasses.dataclass(frozen=True)
class Settings:
    # main algorithm settings (src/settings.jl:72-75)
    max_iter: int = 200
    time_limit: float = float("inf")
    # DELIBERATE deviation from the reference default (verbose=true,
    # settings.jl:74): this solver embeds in jitted pipelines where
    # verbose compiles a per-iteration host callback into the device
    # program (live streaming, loop.py) — silent-by-default is the
    # right library behavior; set verbose=True for the reference's
    # banner + live iteration table.
    verbose: bool = False
    max_step_fraction: float = 0.99

    # full accuracy tolerances (src/settings.jl:78-83)
    tol_gap_abs: float = 1e-8
    tol_gap_rel: float = 1e-8
    tol_feas: float = 1e-8
    tol_infeas_abs: float = 1e-8
    tol_infeas_rel: float = 1e-8
    tol_ktratio: float = 1e-6

    # reduced ("almost solved") tolerances (src/settings.jl:90-95)
    reduced_tol_gap_abs: float = 5e-5
    reduced_tol_gap_rel: float = 5e-5
    reduced_tol_feas: float = 1e-4
    reduced_tol_infeas_abs: float = 5e-12
    reduced_tol_infeas_rel: float = 5e-5
    reduced_tol_ktratio: float = 1e-4

    # data equilibration (src/settings.jl:98-101)
    equilibrate_enable: bool = True
    equilibrate_max_iter: int = 10
    equilibrate_min_scaling: float = 1e-4
    equilibrate_max_scaling: float = 1e4

    # cones & line search (src/settings.jl:104-106)
    linesearch_backtrack_step: float = 0.8
    min_switch_step_length: float = 1e-1
    min_terminate_step_length: float = 1e-4

    # Gondzio-style multiple centrality correctors (no reference
    # counterpart — Clarabel.jl implements Mehrotra + one reduced
    # correction only).  Each corrector round re-solves the combined
    # KKT RHS (back-solve only, the factor is reused) with the trial
    # point's outlier complementarity products pushed back into
    # [beta_min, beta_max]*sigma*mu, and is accepted only if the step
    # length improves.  Symmetric-cone problems only (ignored when
    # exp/pow/genpow cones are present).  Measured on the v5e
    # portfolio-SOCP bench (interleaved warm A/B, round 2): K=1 cuts
    # batch-max iterations 12->10 but the extra back-solves roughly
    # cancel the saving — ~+2% at B=256 and ~-5% at B=4096; K=2 loses
    # at both sizes.  Default therefore 0; enable only for problem
    # families whose iteration counts are corrector-limited.
    centrality_correctors: int = 0
    corrector_beta_min: float = 0.1
    corrector_beta_max: float = 10.0

    # Batch compaction quorum (BatchSolver only; no reference
    # counterpart — the reference solves one problem at a time).  The
    # fused batched loop otherwise runs every problem until the LAST
    # one converges, so the batch pays max-iterations while the mean is
    # lower.  With quorum f in (0, 1), the batch program exits once a
    # fraction >= f of problems is finished; the stragglers are
    # gathered into a narrower program (next power of two wide) and
    # resumed from their exact mid-loop state.  0.0 disables.
    # -1.0 (default) = auto: on (quorum 0.9) when the batch is at least
    # `batch_compaction_min_batch` problems, off below — the measured
    # crossover on the v5e portfolio bench (round-2 interleaved A/B:
    # +23% at B=4096, -13% at B=256; the two extra dispatches and the
    # host gather only amortize at large B).
    batch_compaction: float = -1.0
    batch_compaction_min_batch: int = 1024

    # Single-solve host routing: a lone small solve on a TPU-backend
    # process pays per-dispatch latency plus lane-1 kernel launches on
    # a 128-lane machine, while the same problem solves warm in ~5 ms
    # on the host CPU backend (measured, N=83 portfolio).  "auto"
    # (default) routes single `Solver` solves with KKT dim <= 128 to
    # the in-process CPU backend when the default backend is a TPU and
    # kkt_solve_method is "auto" (an explicit backend choice is
    # respected); "on" forces host routing for any N; "off" disables.
    # Batch/sharded/sparse solvers ignore this (they exist to use the
    # chip).  The reference solves this class on CPU natively — this
    # is the parity policy for latency-critical small problems (MPC).
    host_solve: str = "auto"

    # BatchSolver chunking for very wide batches: the measured
    # throughput curve peaks near B=4096 on v5e (10.2k problems/s
    # device-side) and a monolithic B=8192 program REGRESSES to 9.1k
    # (round-4 batch_scaling artifact) — wider programs enlarge the
    # straggler tail the fused loop runs to, and live HBM grows with
    # B.  With chunking, batches wider than the chunk split into
    # chunk-wide programs that are ALL enqueued before one fence
    # (XLA pipelines them back-to-back), so throughput stays at the
    # sweet spot and peak live intermediates are bounded by the chunk
    # width.  -1 (default) = auto: chunk at 4096 when B > 4096;
    # 0 disables; explicit values chunk at that width.
    batch_chunk_size: int = -1

    # Multi-RHS ("pair") KKT solves: fuse the constant-RHS (-q, b) and
    # affine systems — which share the factorization — into one kernel
    # launch.  None = auto: OFF on the dense backends (v5e portfolio
    # A/B, benchmarks/ab_results/ab_pair.json — no-pair wins ~3-7%;
    # the 2-RHS substitution chain is not free at batch widths that
    # already fill the VPU lanes, and the fused launch serializes work
    # XLA otherwise overlaps) and ON for the device sparse multifrontal
    # (its back-solve is a latency-bound level walk whose cost is paid
    # ONCE for both RHS columns — the pair wiring exists there for
    # exactly that reason).  True/False forces either way.
    kkt_pair_solve: Optional[bool] = None

    # linear solver selection (mirrors the backend registry of
    # src/kktsolvers/direct-ldl/directldl_defaults.jl):
    # "dense" = dense factorization/inversion on device (TPU MXU path);
    # "qdldl" = native C++ sparse LDL^T host-side (CPU path);
    # "arrow" = block-arrow Schur complement partitioned over a device
    #           mesh (tensor-parallel; requires ShardedSolver);
    # "auto"  = "dense" single-device, "arrow" on a mesh.
    direct_solve_method: str = "auto"
    max_threads: int = 0

    # factorization precision: "auto" picks float32+IR on TPU backends
    # and float64 elsewhere; or force "float32"/"float64".
    kkt_factor_precision: str = "auto"

    # dense KKT solve algorithm: "lu" (pivoted, XLA), "inverse"
    # (pivot-free explicit inverse of the regularized quasidefinite K;
    # every solve becomes one MXU matmul — much faster on TPU, same
    # final accuracy via f64 iterative refinement), or "auto"
    # (inverse on TPU, lu elsewhere).
    kkt_solve_method: str = "auto"

    # static regularization (src/settings.jl:117-119)
    static_regularization_enable: bool = True
    static_regularization_constant: float = 1e-8
    static_regularization_proportional: float = _F64_EPS * _F64_EPS

    # dynamic regularization (src/settings.jl:122-124)
    dynamic_regularization_enable: bool = True
    dynamic_regularization_eps: float = 1e-13
    dynamic_regularization_delta: float = 2e-7

    # iterative refinement (src/settings.jl:127-132)
    iterative_refinement_enable: bool = True
    iterative_refinement_reltol: float = 1e-13
    iterative_refinement_abstol: float = 1e-12
    iterative_refinement_max_iter: int = 10
    iterative_refinement_stop_ratio: float = 5.0

    # preprocessing (src/settings.jl:135-136)
    presolve_enable: bool = True
    input_sparse_dropzeros: bool = False

    # chordal decomposition (src/settings.jl:139-142)
    chordal_decomposition_enable: bool = True
    chordal_decomposition_merge_method: str = "clique_graph"
    chordal_decomposition_compact: bool = True
    chordal_decomposition_complete_dual: bool = True

    # reference-compatibility fields accepted so that settings dicts /
    # JSON files written by the reference load unchanged:
    # direct_kkt_solver (src/settings.jl:113) must stay True — the
    # reference itself supports no indirect solver either.
    # pardiso_iparm/pardiso_verbose (src/settings.jl:145-146) configure
    # the Pardiso backend, which has no TPU counterpart; a non-default
    # value warns rather than silently disappearing.  Stored as a tuple
    # (not MVector/list) to keep the dataclass hashable for jit keying.
    direct_kkt_solver: bool = True
    pardiso_iparm: Optional[tuple] = None
    pardiso_verbose: bool = False

    def __post_init__(self):
        # every construction path (direct ctor, replace(), from_dict)
        # must yield a hashable instance — hash(settings) keys the jit
        # cache (module docstring); a list-valued pardiso_iparm would
        # raise TypeError at solve time instead of here
        if isinstance(self.pardiso_iparm, list):
            object.__setattr__(self, "pardiso_iparm", tuple(self.pardiso_iparm))

    def replace(self, **kwargs) -> "Settings":
        return dataclasses.replace(self, **kwargs)

    def resolved_batch_compaction(self, batch_size: int) -> float:
        """Resolve the batch_compaction auto sentinel for a concrete
        batch width (see the field docstring for the measured
        crossover)."""
        q = self.batch_compaction
        if q < 0.0:
            return 0.9 if batch_size >= self.batch_compaction_min_batch else 0.0
        return q

    def resolved_batch_chunk(self, batch_size: int) -> int:
        """Resolve the batch_chunk_size auto sentinel: the chunk width
        actually used (0 = no chunking) for a concrete batch width."""
        c = self.batch_chunk_size
        if c < 0:
            c = 4096
        return c if 0 < c < batch_size else 0

    @classmethod
    def from_dict(cls, d: dict) -> "Settings":
        """Populate from a dict (mirrors settings_populate!,
        src/settings.jl:160-166)."""
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - valid
        if unknown:
            raise ValueError(f"unknown settings: {sorted(unknown)}")
        if isinstance(d.get("pardiso_iparm"), list):
            d = dict(d, pardiso_iparm=tuple(d["pardiso_iparm"]))
        return cls(**d)

    def validate(self) -> None:
        if self.max_iter < 0:
            raise ValueError("max_iter must be nonnegative")
        if not self.direct_kkt_solver:
            # same restriction as the reference (src/settings.jl:113:
            # "indirect not yet supported")
            raise ValueError("direct_kkt_solver=False is not supported")
        # typemin(Int32) entries mean "ignored" in the reference
        # (settings.jl:145) — only a real request deserves a warning
        iparm_set = self.pardiso_iparm is not None and any(
            v != -2147483648 for v in self.pardiso_iparm
        )
        if iparm_set or self.pardiso_verbose:
            import warnings

            warnings.warn(
                "pardiso_iparm/pardiso_verbose are accepted for reference "
                "compatibility but have no effect: there is no Pardiso "
                "backend on TPU",
                stacklevel=2,
            )
        if self.max_threads < 0:
            raise ValueError("max_threads must be >= 0 (0 = automatic)")
        # max_threads is honored by the native host LDL backend
        # (direct_solve_method="qdldl"): level-parallel numeric
        # refactorization over independent elimination-tree levels
        # (native/ldl.cpp ldl_refactor_mt; 0 = auto).  Device paths are
        # parallelized by XLA and ignore it, matching the reference
        # where only the Pardiso/MKL backends consume the setting
        # (settings.jl:108-110).
        if not (0.0 < self.max_step_fraction <= 1.0):
            raise ValueError("max_step_fraction must be in (0, 1]")
        if self.kkt_factor_precision not in ("auto", "float32", "float64"):
            raise ValueError("kkt_factor_precision must be auto|float32|float64")
        if self.direct_solve_method not in ("auto", "dense", "qdldl", "arrow"):
            raise ValueError(f"unknown direct_solve_method {self.direct_solve_method}")
        if self.kkt_solve_method not in ("auto", "lu", "inverse", "pallas",
                                         "qr"):
            raise ValueError(
                "kkt_solve_method must be auto|lu|inverse|pallas|qr")
        if self.centrality_correctors < 0:
            raise ValueError("centrality_correctors must be nonnegative")
        if self.batch_compaction != -1.0 and not (
            0.0 <= self.batch_compaction < 1.0
        ):
            raise ValueError(
                "batch_compaction must be in [0, 1) or -1.0 (auto)")
        if self.batch_compaction_min_batch < 1:
            raise ValueError("batch_compaction_min_batch must be positive")
        if self.batch_chunk_size < -1:
            raise ValueError(
                "batch_chunk_size must be -1 (auto), 0 (off), or a "
                "positive chunk width")
        if self.host_solve not in ("auto", "on", "off"):
            raise ValueError("host_solve must be auto|on|off")
        if not (0.0 < self.corrector_beta_min < 1.0
                < self.corrector_beta_max):
            raise ValueError(
                "corrector betas must satisfy 0 < beta_min < 1 < beta_max")
