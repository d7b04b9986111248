"""Chordal decomposition of PSD cones: a copy of
`cuclarabel_tpu/chordal/` (numpy only), whose `decomp.py` the
`Solver` calls after presolve."""

from .decomp import ChordalInfo, decomp_augment, decomp_reverse

__all__ = ["ChordalInfo", "decomp_augment", "decomp_reverse"]
