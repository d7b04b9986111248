"""The port's batched cone ops (cuclarabel_torch/cones/ops.py) against the
reference's (cuclarabel_tpu/cones/ops.py) on the same inputs.

The reference functions take one problem and are called per problem
(never vmapped: ROADMAP F2).  The port takes the
whole (B, m) batch.  Tolerance 1e-12, relative with a floor of 1: the
two sum in different orders."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuclarabel_tpu.cones.api as ref_api
from cuclarabel_tpu.cones import ops as ref_ops
from cuclarabel_tpu.cones.layout import build_layout as ref_build_layout
import cuclarabel_torch.cones.api as api
from cuclarabel_torch.cones import ops
from cuclarabel_torch.cones.layout import build_layout

B = 3
TOL = 1e-12
SPECS = [("zero", 2), ("nn", 3), ("soc", 4), ("soc", 3), ("nn", 2)]


def _cones(mod):
    kind = {"zero": mod.ZeroConeT, "nn": mod.NonnegativeConeT,
            "soc": mod.SecondOrderConeT}
    return tuple(kind[k](d) for k, d in SPECS)


LAYOUT = build_layout(_cones(api))
REF_LAYOUT = ref_build_layout(_cones(ref_api))
M = LAYOUT.m


def _interior(rng):
    """(B, m) points strictly inside every cone (random elsewhere)."""
    v = rng.standard_normal((B, M))
    v[:, LAYOUT.nn_mask] = rng.uniform(0.2, 2.0, (B, LAYOUT.nn_mask.sum()))
    for lo, hi in (r for c, r in zip(LAYOUT.specs, LAYOUT.ranges)
                   if isinstance(c, api.SecondOrderConeT)):
        v[:, lo] = np.linalg.norm(v[:, lo + 1:hi], axis=1) + \
            rng.uniform(0.1, 1.0, B)
    return v


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    s, z = _interior(rng), _interior(rng)
    mu = rng.uniform(0.5, 1.5, B)
    ref_scal = [ref_ops.update_scaling(REF_LAYOUT, jnp.asarray(s[i]),
                                       jnp.asarray(z[i]), mu[i], 0)[0]
                for i in range(B)]
    return {
        "s": s, "z": z, "mu": mu,
        "dz": rng.standard_normal((B, M)), "ds": rng.standard_normal((B, M)),
        "v": rng.standard_normal((B, M)), "alpha": rng.uniform(0.1, 1.0, B),
        "scal": {k: np.stack([np.asarray(r[k]) for r in ref_scal])
                 for k in ref_scal[0]},
        "ref_scal": ref_scal,
    }


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _gather(d, key):
    return d[key][:, LAYOUT.soc_idx]


def _scal(data):
    return {k: _t(v) for k, v in data["scal"].items()}


# name -> (port(data) -> tensor or tuple, reference(data, i) -> array(s))
CASES = {
    "_seg_sum": (
        lambda d: ops._seg_sum(LAYOUT, _t(_gather(d, "v"))),
        lambda d, i: ref_ops._seg_sum(REF_LAYOUT, _gather(d, "v")[i])),
    "_soc_tail_sumsq": (
        lambda d: ops._soc_tail_sumsq(LAYOUT, _t(_gather(d, "v"))),
        lambda d, i: ref_ops._soc_tail_sumsq(REF_LAYOUT, _gather(d, "v")[i])),
    "_soc_tail_dot": (
        lambda d: ops._soc_tail_dot(LAYOUT, _t(_gather(d, "v")),
                                    _t(_gather(d, "dz"))),
        lambda d, i: ref_ops._soc_tail_dot(
            REF_LAYOUT, _gather(d, "v")[i], _gather(d, "dz")[i])),
    "_soc_full_dot": (
        lambda d: ops._soc_full_dot(LAYOUT, _t(_gather(d, "v")),
                                    _t(_gather(d, "dz"))),
        lambda d, i: ref_ops._soc_full_dot(
            REF_LAYOUT, _gather(d, "v")[i], _gather(d, "dz")[i])),
    "_soc_residual": (
        lambda d: ops._soc_residual(LAYOUT, _t(_gather(d, "v"))),
        lambda d, i: ref_ops._soc_residual(REF_LAYOUT, _gather(d, "v")[i])),
    "_soc_mul_W": (
        lambda d: ops._soc_mul_W(LAYOUT, _t(d["scal"]["soc_eta"]),
                                 _t(d["scal"]["soc_w"]), _t(_gather(d, "v"))),
        lambda d, i: ref_ops._soc_mul_W(
            REF_LAYOUT, d["scal"]["soc_eta"][i], d["scal"]["soc_w"][i],
            _gather(d, "v")[i])),
    "_soc_mul_Winv": (
        lambda d: ops._soc_mul_Winv(LAYOUT, _t(d["scal"]["soc_eta"]),
                                    _t(d["scal"]["soc_w"]),
                                    _t(_gather(d, "v"))),
        lambda d, i: ref_ops._soc_mul_Winv(
            REF_LAYOUT, d["scal"]["soc_eta"][i], d["scal"]["soc_w"][i],
            _gather(d, "v")[i])),
    "_soc_circ": (
        lambda d: ops._soc_circ(LAYOUT, _t(_gather(d, "v")),
                                _t(_gather(d, "dz"))),
        lambda d, i: ref_ops._soc_circ(
            REF_LAYOUT, _gather(d, "v")[i], _gather(d, "dz")[i])),
    "unit_initialization": (
        lambda d: ops.unit_initialization(LAYOUT, B, "cpu"),
        lambda d, i: ref_ops.unit_initialization(REF_LAYOUT)),
    "margins": (
        lambda d: ops.margins(LAYOUT, _t(d["v"]), ops.DUAL),
        lambda d, i: ref_ops.margins(REF_LAYOUT, d["v"][i], ref_ops.DUAL)),
    "scaled_unit_shift": (
        lambda d: ops.scaled_unit_shift(LAYOUT, _t(d["v"]), _t(d["alpha"]),
                                        ops.PRIMAL),
        lambda d, i: ref_ops.scaled_unit_shift(
            REF_LAYOUT, d["v"][i], d["alpha"][i], ref_ops.PRIMAL)),
    "shift_to_cone_interior_primal": (
        lambda d: ops.shift_to_cone_interior(LAYOUT, _t(d["v"]), ops.PRIMAL),
        lambda d, i: ref_ops.shift_to_cone_interior(
            REF_LAYOUT, d["v"][i], ref_ops.PRIMAL)),
    "shift_to_cone_interior_dual": (
        lambda d: ops.shift_to_cone_interior(LAYOUT, _t(d["s"]), ops.DUAL),
        lambda d, i: ref_ops.shift_to_cone_interior(
            REF_LAYOUT, d["s"][i], ref_ops.DUAL)),
    "set_identity_scaling": (
        lambda d: ops.set_identity_scaling(LAYOUT, B, "cpu"),
        lambda d, i: ref_ops.set_identity_scaling(REF_LAYOUT)),
    "update_scaling": (
        lambda d: ops.update_scaling(LAYOUT, _t(d["s"]), _t(d["z"]),
                                     _t(d["mu"]), 0),
        lambda d, i: ref_ops.update_scaling(
            REF_LAYOUT, d["s"][i], d["z"][i], d["mu"][i], 0)),
    "assemble_Hs_dense": (
        lambda d: ops.assemble_Hs_dense(LAYOUT, _scal(d)),
        lambda d, i: ref_ops.assemble_Hs_dense(REF_LAYOUT,
                                               d["ref_scal"][i])),
    "mul_Hs": (
        lambda d: ops.mul_Hs(LAYOUT, _scal(d), _t(d["v"])),
        lambda d, i: ref_ops.mul_Hs(REF_LAYOUT, d["ref_scal"][i],
                                    d["v"][i])),
    "affine_ds": (
        lambda d: ops.affine_ds(LAYOUT, _scal(d), _t(d["s"])),
        lambda d, i: ref_ops.affine_ds(REF_LAYOUT, d["ref_scal"][i],
                                       d["s"][i])),
    "combined_ds_shift": (
        lambda d: ops.combined_ds_shift(LAYOUT, _scal(d), _t(d["dz"]),
                                        _t(d["ds"]), _t(d["mu"]),
                                        _t(d["z"])),
        lambda d, i: ref_ops.combined_ds_shift(
            REF_LAYOUT, d["ref_scal"][i], d["dz"][i], d["ds"][i],
            d["mu"][i], d["z"][i])),
    "centrality_correction": (
        lambda d: ops.centrality_correction(
            LAYOUT, _scal(d), _t(d["z"]), _t(d["s"]), 0.1 * _t(d["mu"]),
            2.0 * _t(d["mu"])),
        lambda d, i: ref_ops.centrality_correction(
            REF_LAYOUT, d["ref_scal"][i], d["z"][i], d["s"][i],
            0.1 * d["mu"][i], 2.0 * d["mu"][i])),
    "ds_from_dz_offset": (
        lambda d: ops.ds_from_dz_offset(LAYOUT, _scal(d), _t(d["ds"]),
                                        _t(d["z"])),
        lambda d, i: ref_ops.ds_from_dz_offset(
            REF_LAYOUT, d["ref_scal"][i], d["ds"][i], d["z"][i])),
    "_nn_step_limit": (
        lambda d: ops._nn_step_limit(LAYOUT, _t(d["z"]), _t(d["dz"]),
                                     _t(d["alpha"])),
        lambda d, i: ref_ops._nn_step_limit(REF_LAYOUT, d["z"][i],
                                            d["dz"][i], d["alpha"][i])),
    "_soc_step_limit": (
        lambda d: ops._soc_step_limit(LAYOUT, _t(d["s"]), _t(d["ds"]),
                                      _t(d["alpha"])),
        lambda d, i: ref_ops._soc_step_limit(REF_LAYOUT, d["s"][i],
                                             d["ds"][i], d["alpha"][i])),
    "step_length": (
        lambda d: ops.step_length(LAYOUT, _scal(d), _t(d["dz"]), _t(d["ds"]),
                                  _t(d["z"]), _t(d["s"]), _t(d["alpha"]),
                                  None),
        lambda d, i: ref_ops.step_length(
            REF_LAYOUT, d["ref_scal"][i], d["dz"][i], d["ds"][i], d["z"][i],
            d["s"][i], d["alpha"][i], None)),
}


def _leaves(out, prefix=""):
    """Flatten a result (tensor, or tuples and dicts of them) into named
    arrays."""
    if isinstance(out, dict):
        items = out.items()
    elif isinstance(out, (tuple, list)):
        items = ((str(j), v) for j, v in enumerate(out))
    else:
        return {prefix: np.asarray(out)}
    flat = {}
    for k, v in items:
        flat.update(_leaves(v, f"{prefix}/{k}"))
    return flat


def _jax(d):
    """The same data as jax arrays, for the reference."""
    if isinstance(d, dict):
        return {k: _jax(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_jax(v) for v in d]
    return jnp.asarray(d)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(data, name):
    port_fn, ref_fn = CASES[name]
    got = _leaves(port_fn(data))
    for i in range(B):
        want = _leaves(ref_fn(_jax(data), i))
        assert set(got) == set(want), name
        for k in want:
            w = np.asarray(want[k], dtype=np.float64)
            g = np.asarray(got[k][i], dtype=np.float64)
            assert g.shape == w.shape, (name, k)
            np.testing.assert_allclose(
                g, w, rtol=TOL, atol=TOL * max(1.0, np.abs(w).max()),
                err_msg=f"{name}[{k}] problem {i}")


def test_psd_cone_plan_matches_reference():
    """The PSD triangle cone, which raised before it was ported: its plan
    holds the layout's size groups, and the unit initialization and the
    Hs at the identity scaling of a layout with NN and PSD cones of two
    sides match the reference's (tests/test_torch_psd_units.py holds the
    rest)."""
    cones = (api.NonnegativeConeT(2), api.PSDTriangleConeT(3),
             api.PSDTriangleConeT(2), api.PSDTriangleConeT(3))
    ref_cones = (ref_api.NonnegativeConeT(2), ref_api.PSDTriangleConeT(3),
                 ref_api.PSDTriangleConeT(2), ref_api.PSDTriangleConeT(3))
    layout, ref_layout = build_layout(cones), ref_build_layout(ref_cones)
    groups = ops.plan(layout, "cpu").psd_groups
    assert [(g.r, g.idx.tolist()) for g in groups] == [
        (r, idx.tolist()) for r, idx in sorted(ref_layout.psd_groups.items())]
    z, s = ops.unit_initialization(layout, B, "cpu")
    rz, rs = ref_ops.unit_initialization(ref_layout)
    for got, want in ((z, rz), (s, rs)):
        for i in range(B):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    state = ops.set_identity_scaling(layout, B, "cpu")
    want = np.asarray(ref_ops.assemble_Hs_dense(
        ref_layout, ref_ops.set_identity_scaling(ref_layout)))
    got = ops.assemble_Hs_dense(layout, state).numpy()
    for i in range(B):
        np.testing.assert_array_equal(got[i], want)


def test_exponential_cone_plan_matches_reference():
    """The exponential cone, which raised before it was ported: its plan
    builds, and the unit initialization and the Hs of a layout with NN
    and exp cones match the reference's
    (tests/test_torch_nonsym_units.py holds the rest)."""
    cones = (api.NonnegativeConeT(2), api.ExponentialConeT(),
             api.ExponentialConeT())
    ref_cones = (ref_api.NonnegativeConeT(2), ref_api.ExponentialConeT(),
                 ref_api.ExponentialConeT())
    layout, ref_layout = build_layout(cones), ref_build_layout(ref_cones)
    assert ops.plan(layout, "cpu").exp_idx.tolist() == [[2, 3, 4],
                                                        [5, 6, 7]]
    z, s = ops.unit_initialization(layout, B, "cpu")
    rz, rs = ref_ops.unit_initialization(ref_layout)
    for got, want in ((z, rz), (s, rs)):
        for i in range(B):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    state, ok = ops.update_scaling(layout, s, z, torch.ones(B), 0)
    ref_state, ref_ok = ref_ops.update_scaling(ref_layout, rs, rz, 1.0, 0)
    assert ok.all() and bool(ref_ok)
    want = np.asarray(ref_ops.assemble_Hs_dense(ref_layout, ref_state))
    got = ops.assemble_Hs_dense(layout, state).numpy()
    for i in range(B):
        np.testing.assert_allclose(got[i], want, rtol=TOL, atol=TOL)
