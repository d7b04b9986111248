"""Static cone layout: the array-based replacement for the reference's
`CompositeCone` object tree (`src/cones/compositecone_type.jl`).

A copy of `cuclarabel_tpu/cones/layout.py` (numpy only).  The port's
cone ops (`cones/ops.py`) move the index plans below onto the solve's
torch device once per (layout, device).

Design: "arrays, not objects". All numeric cone state (s, z, scaling
points w/lambda/eta, Hessian blocks) lives in flat device arrays.  This
module precomputes, once per problem structure, the *static* index plans
that let every cone operation run as a grouped, vectorized kernel per
cone type:

  * Zero / Nonnegative cones: boolean masks over the (m,) slack vector —
    purely elementwise kernels.
  * Second-order cones: a gathered subvector with segment ids, so the
    per-cone reductions (tail norms, dots) become `segment_sum`s and the
    per-cone scalars broadcast back with a gather. Heterogeneous cone
    sizes need no padding.
  * Exponential / power cones: (ncones, 3) index matrices for batched
    closed-form Hessian kernels.
  * Generalized power cones: gathered segments like SOC (two segment
    classes: the alpha-head part and the dim2 tail part).
  * PSD triangle cones: grouped by matrix side length, (ncones, svec)
    index matrices feeding batched Cholesky/SVD.

Everything in this class is numpy (host) data.
"""

import functools
from typing import List, Sequence, Tuple

import numpy as np

from . import api
from .api import (
    SupportedCone,
    ZeroConeT,
    NonnegativeConeT,
    SecondOrderConeT,
    ExponentialConeT,
    PowerConeT,
    GenPowerConeT,
    PSDTriangleConeT,
)


class ConeLayout:
    """Static per-problem cone metadata and index plans."""

    def __init__(self, cones: Sequence[SupportedCone]):
        cones = tuple(cones)
        self.specs = cones

        # ranges of each cone in the (m,) slack vector, like the
        # reference's rng_cones (compositecone_type.jl:60-62)
        ranges: List[Tuple[int, int]] = []
        ofs = 0
        for c in cones:
            d = api.nvars(c)
            ranges.append((ofs, ofs + d))
            ofs += d
        self.ranges = tuple(ranges)
        self.m = ofs

        self.degree = sum(api.degree(c) for c in cones)
        self.is_symmetric = all(api.is_symmetric_cone(c) for c in cones)
        self.allows_primal_dual_scaling = all(
            api.allows_primal_dual_scaling(c) for c in cones
        )

        m = self.m
        zero_mask = np.zeros(m, dtype=bool)
        nn_mask = np.zeros(m, dtype=bool)

        soc_idx: List[np.ndarray] = []
        soc_dims: List[int] = []

        exp_idx: List[np.ndarray] = []
        pow_idx: List[np.ndarray] = []
        pow_alpha: List[float] = []

        gp_specs: List[Tuple[Tuple[float, ...], int, int]] = []  # (alpha, dim2, start)

        psd_groups = {}  # side length -> list of start offsets

        for c, (lo, hi) in zip(cones, ranges):
            if isinstance(c, ZeroConeT):
                zero_mask[lo:hi] = True
            elif isinstance(c, NonnegativeConeT):
                nn_mask[lo:hi] = True
            elif isinstance(c, SecondOrderConeT):
                soc_idx.append(np.arange(lo, hi, dtype=np.int32))
                soc_dims.append(hi - lo)
            elif isinstance(c, ExponentialConeT):
                exp_idx.append(np.arange(lo, hi, dtype=np.int32))
            elif isinstance(c, PowerConeT):
                pow_idx.append(np.arange(lo, hi, dtype=np.int32))
                pow_alpha.append(c.alpha)
            elif isinstance(c, GenPowerConeT):
                gp_specs.append((c.alpha, c.dim2, lo))
            elif isinstance(c, PSDTriangleConeT):
                psd_groups.setdefault(c.dim, []).append(lo)
            else:
                raise TypeError(f"unsupported cone {c}")

        self.zero_mask = zero_mask
        self.nn_mask = nn_mask
        self.has_zero = bool(zero_mask.any())
        self.has_nn = bool(nn_mask.any())

        # ---- second-order cones: segment plan --------------------------
        self.nsoc = len(soc_dims)
        self.has_soc = self.nsoc > 0
        if self.has_soc:
            self.soc_dims = np.asarray(soc_dims, dtype=np.int32)
            self.soc_idx = np.concatenate(soc_idx)  # (msoc,) into m
            seg = np.concatenate(
                [np.full(d, i, dtype=np.int32) for i, d in enumerate(soc_dims)]
            )
            self.soc_seg = seg
            headpos = np.cumsum(np.concatenate([[0], soc_dims[:-1]])).astype(np.int32)
            self.soc_headpos = headpos  # position of each head in gathered array
            is_head = np.zeros(len(seg), dtype=bool)
            is_head[headpos] = True
            self.soc_is_head = is_head
            self.soc_sign = np.where(is_head, 1.0, -1.0)  # J-matrix signs
            self.soc_head_full = self.soc_idx[headpos]  # head indices in m-vector
            # full-length segment-id vector for Hs assembly (-1 = not SOC)
            segfull = np.full(m, -1, dtype=np.int32)
            segfull[self.soc_idx] = seg
            self.soc_segfull = segfull
            self.msoc = len(self.soc_idx)

        # ---- exponential cones ------------------------------------------
        self.nexp = len(exp_idx)
        self.has_exp = self.nexp > 0
        if self.has_exp:
            self.exp_idx = np.stack(exp_idx)  # (nexp, 3)

        # ---- power cones -------------------------------------------------
        self.npow = len(pow_idx)
        self.has_pow = self.npow > 0
        if self.has_pow:
            self.pow_idx = np.stack(pow_idx)  # (npow, 3)
            self.pow_alpha = np.asarray(pow_alpha, dtype=np.float64)

        # ---- generalized power cones (padded batch plan) ----------------
        self.ngp = len(gp_specs)
        self.has_genpow = self.ngp > 0
        if self.has_genpow:
            d1max = max(len(a) for a, _, _ in gp_specs)
            d2max = max(d2 for _, d2, _ in gp_specs)
            # padded gather indices; padding points at the cone's own
            # first element but is masked out everywhere it matters
            gp_idx1 = np.zeros((self.ngp, d1max), dtype=np.int32)
            gp_idx2 = np.zeros((self.ngp, max(d2max, 1)), dtype=np.int32)
            gp_mask1 = np.zeros((self.ngp, d1max), dtype=bool)
            gp_mask2 = np.zeros((self.ngp, max(d2max, 1)), dtype=bool)
            gp_alpha = np.zeros((self.ngp, d1max), dtype=np.float64)
            for i, (alpha, dim2, lo) in enumerate(gp_specs):
                d1 = len(alpha)
                gp_idx1[i, :] = lo  # padding target
                gp_idx1[i, :d1] = np.arange(lo, lo + d1)
                gp_mask1[i, :d1] = True
                gp_alpha[i, :d1] = alpha
                gp_idx2[i, :] = lo
                if dim2 > 0:
                    gp_idx2[i, :dim2] = np.arange(lo + d1, lo + d1 + dim2)
                    gp_mask2[i, :dim2] = True
            self.gp_idx1, self.gp_idx2 = gp_idx1, gp_idx2
            self.gp_mask1, self.gp_mask2 = gp_mask1, gp_mask2
            self.gp_alpha = gp_alpha
            self.gp_dim1 = np.asarray([len(a) for a, _, _ in gp_specs], np.int32)
            self.gp_dim2 = np.asarray([d2 for _, d2, _ in gp_specs], np.int32)
            self.gp_starts = np.asarray([lo for _, _, lo in gp_specs], np.int32)

        # ---- PSD triangle cones: size-grouped batches --------------------
        # dict: side length r -> (ncones, svec_dim) gather index matrix
        self.psd_groups = {}
        for r, starts in sorted(psd_groups.items()):
            sd = api.triangular_number(r)
            idx = np.stack([np.arange(lo, lo + sd, dtype=np.int32) for lo in starts])
            self.psd_groups[r] = idx
        self.has_psd = len(self.psd_groups) > 0
        self.npsd = sum(v.shape[0] for v in self.psd_groups.values())

        # nonsymmetric cone count (for the interior backoff in step_length,
        # coneops_compositecone.jl:233-237)
        self.has_nonsymmetric = not self.is_symmetric

        # cache key for jit specialization
        self.key = cones

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, ConeLayout) and self.key == other.key

    # ---- host-side helpers ----------------------------------------------

    def rectification_ranges(self) -> List[Tuple[int, int]]:
        """Ranges of cones that require scalar (non-elementwise)
        equilibration: SOC, PSD, exp, pow, genpow.  Zero and nonnegative
        cones allow elementwise scaling (coneops_nncone.jl:8-17,
        coneops_defaults.jl:32-44)."""
        out = []
        for c, rng in zip(self.specs, self.ranges):
            if not isinstance(c, (ZeroConeT, NonnegativeConeT)):
                out.append(rng)
        return out


@functools.lru_cache(maxsize=256)
def build_layout(cones: Tuple[SupportedCone, ...]) -> ConeLayout:
    return ConeLayout(cones)
