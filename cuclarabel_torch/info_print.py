"""Console progress reporting: banner, configuration summary,
per-iteration table, footer.

A copy of `cuclarabel_tpu/info_print.py` (the JAX package is the
reference; the port imports nothing from it) whose banner names the
port.  Parity with the reference's `src/info_print.jl`
(banner/configuration at 2-120, per-iteration status line at 122-160).
The IPM loop (ipm/loop.py) streams one row per iteration through
`format_iteration_row` when `Settings.verbose` is set, as the reference
streams its @printf lines; that costs one host sync per iteration.
"""

import numpy as np


def _count_cones(cones):
    from .cones import api

    by_type = {}
    for c in cones:
        by_type.setdefault(type(c).__name__, []).append(api.nvars(c))
    return by_type


def print_banner(settings) -> None:
    print("-------------------------------------------------------------")
    print(f"      cuclarabel_torch v{_version()} - conic IPM on PyTorch/CUDA")
    print("             (c) 2026 — behavioral parity: Clarabel v0.11")
    print("-------------------------------------------------------------")


def _version():
    from . import __version__

    return __version__


def print_configuration(settings, n, m, cones, has_P, backend: str) -> None:
    print(f"problem:\n  variables     = {n}")
    print(f"  constraints   = {m}")
    by_type = _count_cones(cones)
    print(f"  cones (total) = {len(cones)}")
    for name, dims in sorted(by_type.items()):
        dmin, dmax = min(dims), max(dims)
        rng = f"{dmin}" if dmin == dmax else f"{dmin} .. {dmax}"
        print(f"    : {name:<18s} = {len(dims)},  numel = ({rng})")
    print("settings:")
    print(f"  linear algebra: KKT backend = {backend}")
    print(
        f"  max iter = {settings.max_iter}, time limit = "
        f"{settings.time_limit},  max step = {settings.max_step_fraction:.3f}"
    )
    print(
        f"  tol_feas = {settings.tol_feas:.1e}, tol_gap_abs = "
        f"{settings.tol_gap_abs:.1e}, tol_gap_rel = {settings.tol_gap_rel:.1e}"
    )
    print(
        f"  static reg : {'on' if settings.static_regularization_enable else 'off'}"
        f", eps1 = {settings.static_regularization_constant:.1e}"
    )
    print(
        f"  iter refine: {'on' if settings.iterative_refinement_enable else 'off'}"
        f", reltol = {settings.iterative_refinement_reltol:.1e}, "
        f"abstol = {settings.iterative_refinement_abstol:.1e}"
    )
    print(
        f"  equilibrate: {'on' if settings.equilibrate_enable else 'off'}, "
        f"min_scale = {settings.equilibrate_min_scaling:.1e}, "
        f"max_scale = {settings.equilibrate_max_scaling:.1e}"
    )


_HEADER = (
    "iter    pcost        dcost       gap       pres      dres      "
    "k/t        μ       step     ir  scal"
)


def format_iteration_row(i: int, row) -> str:
    """One status line; row layout as in print_iteration_history."""
    step = "------" if i == 0 else f"{row[7]:.2e}"
    ir = int(row[9]) if len(row) > 9 else 0
    scal = "PD" if len(row) > 10 and row[10] == 0 else "D "
    return (
        f"{i:3d}  {row[0]:+.4e}  {row[1]:+.4e}  {row[2]:.2e}  "
        f"{row[3]:.2e}  {row[4]:.2e}  {row[5]:.2e}  {row[6]:.2e}  {step}"
        f"  {ir:3d}  {scal}"
    )


def print_iteration_header() -> None:
    print(_HEADER)
    print("-" * len(_HEADER))


def print_iteration_history(hist: np.ndarray, niter: int) -> None:
    """hist rows: [pcost, dcost, gap_rel, pres, dres, ktratio, mu,
    step, iter, ir_last, scaling] — slot 9 is THIS iteration's
    refinement-pass count (ir_last; the cumulative total is the
    solution's ir_count field).  The ir/scal columns mirror the
    reference status line's refinement-count and scaling-strategy
    fields (info_print.jl:122-160)."""
    print_iteration_header()
    for i in range(min(niter + 1, hist.shape[0])):
        print(format_iteration_row(i, hist[i]))


def print_footer(solution) -> None:
    from .statuscodes import status_to_string

    print("-" * len(_HEADER))
    print(
        f"Terminated with status = {status_to_string(solution.status)}"
    )
    print(f"solve time = {solution.solve_time*1e3:.2f}ms")
