"""Module-level infinity threshold used by the presolver.

A copy of `cuclarabel_tpu/infinity.py` (the port imports nothing of the JAX
package).

Behavioral parity with the reference's module global
(`src/Clarabel.jl:14-20`): values of `b` at or above this threshold are
treated as +inf bounds and the corresponding nonnegative-cone rows are
eliminated by presolve.
"""

_DEFAULT_INFINITY = 1e20
_infinity = _DEFAULT_INFINITY


def get_infinity() -> float:
    return _infinity


def set_infinity(v: float) -> None:
    global _infinity
    _infinity = float(v)


def default_infinity() -> None:
    set_infinity(_DEFAULT_INFINITY)
