"""User-facing cone specifications.

A copy of `cuclarabel_tpu/cones/api.py` (the port imports nothing of the JAX
package).

Parity with the reference's `SupportedCone` marker types and helpers
(`src/cones/cone_api.jl:18-153`): `nvars` for slack-variable counts and
`cones_collapsed` for the cone-consolidation pass (merging runs of
nonnegative cones, 1-d SOC/PSD singletons, and dropping empty cones).

These are *host-side static metadata* only; all numeric cone state lives
in flat device arrays managed by `ConeLayout` (layout.py).
"""

import dataclasses
from typing import List, Sequence, Tuple
import numpy as np


class SupportedCone:
    """Base marker for user cone specifications."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class ZeroConeT(SupportedCone):
    dim: int


@dataclasses.dataclass(frozen=True)
class NonnegativeConeT(SupportedCone):
    dim: int


@dataclasses.dataclass(frozen=True)
class SecondOrderConeT(SupportedCone):
    dim: int


@dataclasses.dataclass(frozen=True)
class ExponentialConeT(SupportedCone):
    pass  # dim = 3 always


@dataclasses.dataclass(frozen=True)
class PowerConeT(SupportedCone):
    alpha: float

    def __post_init__(self):
        if not (0.0 < self.alpha < 1.0):
            raise ValueError("PowerConeT alpha must be in (0,1)")


@dataclasses.dataclass(frozen=True)
class GenPowerConeT(SupportedCone):
    """Generalized power cone with exponent vector alpha and dim2 extra
    variables (`src/cones/cone_api.jl:37-47`)."""

    alpha: Tuple[float, ...]
    dim2: int

    def __init__(self, alpha: Sequence[float], dim2: int):
        alpha = tuple(float(a) for a in alpha)
        if not all(a > 0 for a in alpha):
            raise ValueError("GenPowerConeT alpha entries must be positive")
        if abs(sum(alpha) - 1.0) > np.finfo(np.float64).eps * len(alpha) / 2 * 10:
            raise ValueError("GenPowerConeT alpha must sum to 1")
        object.__setattr__(self, "alpha", alpha)
        object.__setattr__(self, "dim2", int(dim2))


@dataclasses.dataclass(frozen=True)
class PSDTriangleConeT(SupportedCone):
    dim: int  # side length of the matrix; numel = dim*(dim+1)/2


def triangular_number(k: int) -> int:
    return k * (k + 1) // 2


def nvars(cone: SupportedCone) -> int:
    """Number of slack variables generated by this cone
    (`src/cones/cone_api.jl:61-74`)."""
    if isinstance(cone, PSDTriangleConeT):
        return triangular_number(cone.dim)
    if isinstance(cone, (ExponentialConeT, PowerConeT)):
        return 3
    if isinstance(cone, GenPowerConeT):
        return len(cone.alpha) + cone.dim2
    return cone.dim


def degree(cone: SupportedCone) -> int:
    """Barrier degree of the cone."""
    if isinstance(cone, ZeroConeT):
        return 0
    if isinstance(cone, SecondOrderConeT):
        return 1
    if isinstance(cone, PSDTriangleConeT):
        return cone.dim
    if isinstance(cone, (ExponentialConeT, PowerConeT)):
        return 3
    if isinstance(cone, GenPowerConeT):
        return len(cone.alpha) + 1
    return cone.dim  # NonnegativeConeT


def is_symmetric_cone(cone: SupportedCone) -> bool:
    """Zero cone reports symmetric (dummy equality handling,
    `src/cones/coneops_zerocone.jl:9-14`)."""
    return isinstance(
        cone, (ZeroConeT, NonnegativeConeT, SecondOrderConeT, PSDTriangleConeT)
    )


def allows_primal_dual_scaling(cone: SupportedCone) -> bool:
    """GenPowerCone is dual-scaling only
    (`src/cones/coneops_genpowcone.jl:21`)."""
    return not isinstance(cone, GenPowerConeT)


def _is_collapsible(cone: SupportedCone) -> bool:
    if isinstance(cone, NonnegativeConeT):
        return True
    if isinstance(cone, SecondOrderConeT) and cone.dim == 1:
        return True
    if isinstance(cone, PSDTriangleConeT) and cone.dim == 1:
        return True
    return False


def cones_collapsed(cones: Sequence[SupportedCone]) -> List[SupportedCone]:
    """Consolidate the cone list: drop empty cones, and merge maximal runs
    of {NonnegativeConeT, 1-d SecondOrderConeT, 1-d PSDTriangleConeT}
    (each equivalent to R+) into single NonnegativeConeT blocks.

    Behavioral parity with `cones_new_collapsed`
    (`src/cones/cone_api.jl:96-153`): a run *starts* at a collapsible
    cone and absorbs subsequent collapsible or empty cones; an empty cone
    outside a run is simply dropped.
    """
    out: List[SupportedCone] = []
    i = 0
    n = len(cones)
    while i < n:
        cone = cones[i]
        i += 1
        if nvars(cone) == 0:
            continue
        if _is_collapsible(cone):
            total = nvars(cone)
            while i < n:
                nxt = cones[i]
                if nvars(nxt) == 0:
                    i += 1
                elif _is_collapsible(nxt):
                    total += nvars(nxt)
                    i += 1
                else:
                    break
            out.append(NonnegativeConeT(total))
        else:
            out.append(cone)
    return out
