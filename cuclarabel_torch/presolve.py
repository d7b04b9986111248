"""Presolver: eliminate nonnegative-cone rows with infinite bounds.

A copy of `cuclarabel_tpu/presolve.py` (the JAX package is the
reference; the port imports nothing from it); its relative imports
resolve to the port's own `cones.api`.

Behavioral parity with `src/presolver.jl`: rows of nonnegative cones
whose b[i] >= INFINITY*(1 - 10 eps) are dropped; the reverse pass
reinserts them with s = infbound, z = 0 (presolver.jl:85-107).
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .cones import api
from .cones.api import NonnegativeConeT, SupportedCone


@dataclasses.dataclass
class Presolver:
    keep: np.ndarray  # (m_full,) bool
    mfull: int
    mreduced: int
    infbound: float

    @property
    def count_reduced(self) -> int:
        return self.mfull - self.mreduced


def try_presolve(
    cones: Sequence[SupportedCone], b: np.ndarray, settings, infbound: float
) -> Optional[Presolver]:
    """Build the reduction map, or None if no reduction
    (presolver.jl:110-152)."""
    if not settings.presolve_enable:
        return None
    m = b.shape[0]
    keep = np.ones(m, dtype=bool)
    thresh = infbound * (1.0 - 10.0 * np.finfo(np.float64).eps)
    idx = 0
    for cone in cones:
        ne = api.nvars(cone)
        if isinstance(cone, NonnegativeConeT):
            rng = slice(idx, idx + ne)
            keep[rng] = b[rng] <= thresh
        idx += ne
    mreduced = int(keep.sum())
    if mreduced == m:
        return None
    return Presolver(keep=keep, mfull=m, mreduced=mreduced, infbound=infbound)


def apply_presolve(
    ps: Presolver,
    A: np.ndarray,
    b: np.ndarray,
    cones: Sequence[SupportedCone],
) -> Tuple[np.ndarray, np.ndarray, List[SupportedCone]]:
    """Reduce A, b and the cone list (presolver.jl:27-83)."""
    A_new = A[ps.keep, :]
    b_new = b[ps.keep]
    cones_new: List[SupportedCone] = []
    idx = 0
    for cone in cones:
        ne = api.nvars(cone)
        if isinstance(cone, NonnegativeConeT):
            nkeep = int(ps.keep[idx : idx + ne].sum())
            if nkeep > 0:
                cones_new.append(NonnegativeConeT(nkeep))
        else:
            cones_new.append(cone)
        idx += ne
    return A_new, b_new, cones_new


def reverse_presolve(
    ps: Presolver, s_red: np.ndarray, z_red: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Reinsert dropped rows: s = infbound, z = 0
    (presolver.jl:85-107)."""
    s = np.full(ps.mfull, ps.infbound, dtype=np.float64)
    z = np.zeros(ps.mfull, dtype=np.float64)
    s[ps.keep] = s_red
    z[ps.keep] = z_red
    return s, z
