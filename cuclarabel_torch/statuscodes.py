"""Solver status codes.

A copy of `cuclarabel_tpu/statuscodes.py` (the port imports nothing of the JAX
package).

Parity with the reference 11-state enum (`src/statuscodes.jl:24-36`).
Integer values are stable: they are carried through jitted code as int32
state and mapped back to this enum on the host.
"""

import enum


class SolverStatus(enum.IntEnum):
    UNSOLVED = 0
    SOLVED = 1
    PRIMAL_INFEASIBLE = 2
    DUAL_INFEASIBLE = 3
    ALMOST_SOLVED = 4
    ALMOST_PRIMAL_INFEASIBLE = 5
    ALMOST_DUAL_INFEASIBLE = 6
    MAX_ITERATIONS = 7
    MAX_TIME = 8
    NUMERICAL_ERROR = 9
    INSUFFICIENT_PROGRESS = 10


_STATUS_STRINGS = {
    SolverStatus.UNSOLVED: "unsolved",
    SolverStatus.SOLVED: "solved",
    SolverStatus.PRIMAL_INFEASIBLE: "primal infeasible",
    SolverStatus.DUAL_INFEASIBLE: "dual infeasible",
    SolverStatus.ALMOST_SOLVED: "solved (reduced accuracy)",
    SolverStatus.ALMOST_PRIMAL_INFEASIBLE: "primal infeasible (reduced accuracy)",
    SolverStatus.ALMOST_DUAL_INFEASIBLE: "dual infeasible (reduced accuracy)",
    SolverStatus.MAX_ITERATIONS: "iteration limit",
    SolverStatus.MAX_TIME: "time limit",
    SolverStatus.NUMERICAL_ERROR: "numerical error",
    SolverStatus.INSUFFICIENT_PROGRESS: "insufficient progress",
}


def status_to_string(status: SolverStatus) -> str:
    return _STATUS_STRINGS[SolverStatus(status)]


def status_is_infeasible(status: SolverStatus) -> bool:
    """Any of the infeasibility codes (`src/statuscodes.jl:52-60`)."""
    return SolverStatus(status) in (
        SolverStatus.PRIMAL_INFEASIBLE,
        SolverStatus.DUAL_INFEASIBLE,
        SolverStatus.ALMOST_PRIMAL_INFEASIBLE,
        SolverStatus.ALMOST_DUAL_INFEASIBLE,
    )


def status_is_errored(status: SolverStatus) -> bool:
    """Any of the error codes (`src/statuscodes.jl:62-68`)."""
    return SolverStatus(status) in (
        SolverStatus.NUMERICAL_ERROR,
        SolverStatus.INSUFFICIENT_PROGRESS,
    )
