"""The port's PSD triangle cones (cuclarabel_torch/cones/psd.py and their
dispatch in cones/ops.py) against the reference's
(cuclarabel_tpu/cones/psd.py, cones/ops.py) on the same inputs.

Inputs are seeded numpy interior points of B = 3 and B = 5 problems
whose PSD cones have sides 2, 3 and 5, several cones per side, alone,
beside zero, nonnegative and second-order cones, and beside power cones
(a nonsymmetric layout).  The reference functions take one problem and
are called per problem (never vmapped: ROADMAP F2); the port takes the
batch.  Operations that take a scaling state run on one and the same
state, the reference's, carried across with
`interop.scaling_state_from_reference`.  The SVD of the scaling update is
not unique, so `update_scaling` is held by its invariants (lambda, R R',
Rinv' Rinv and Hs), never by R itself.  Tolerances: 1e-12 relative
(atol 1e-12 x max|ref|) for the algebraic maps, 1e-10 for what passes
through a decomposition."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuclarabel_tpu.cones.api as ref_api
from cuclarabel_tpu.cones import ops as ref_ops
from cuclarabel_tpu.cones import psd as ref_psd
from cuclarabel_tpu.cones.layout import build_layout as ref_build_layout
from cuclarabel_tpu.settings import Settings as RefSettings
from cuclarabel_torch import interop
from cuclarabel_torch.cones import api, ops, psd
from cuclarabel_torch.cones.layout import build_layout
from cuclarabel_torch.problems import smat, svec
from cuclarabel_torch.settings import Settings

TOL = 1e-12
TOL_DEC = 1e-10
# (name, zero, nn, soc dims, psd sides in layout order, pow alphas)
LAYOUTS = {
    "psd_only": (0, 0, (), (2, 3, 5, 3, 2, 2), ()),
    "mixed": (1, 2, (3,), (3, 2, 5, 3), ()),
    "psd_pow": (0, 1, (), (3, 2, 2), (0.4, 0.6)),
}


def _specs(mod, name):
    zero, nn, socs, sides, alphas = LAYOUTS[name]
    cones = []
    if zero:
        cones.append(mod.ZeroConeT(zero))
    if nn:
        cones.append(mod.NonnegativeConeT(nn))
    cones += [mod.SecondOrderConeT(d) for d in socs]
    cones += [mod.PSDTriangleConeT(r) for r in sides]
    cones += [mod.PowerConeT(a) for a in alphas]
    return tuple(cones)


def _pd_svec(rng, r):
    G = rng.standard_normal((r, r))
    return svec(G @ G.T / r + rng.uniform(0.2, 1.0) * np.eye(r))


def _interior(layout, rng, B):
    """(s, z) (B, m), strictly inside every cone of `layout`."""
    m = layout.m
    s, z = rng.standard_normal((B, m)), rng.standard_normal((B, m))
    for v in (s, z):
        v[:, layout.nn_mask] = rng.uniform(0.2, 2.0,
                                           (B, layout.nn_mask.sum()))
    for c, (lo, hi) in zip(layout.specs, layout.ranges):
        kind = type(c).__name__
        for v in (s, z):
            if kind == "SecondOrderConeT":
                v[:, lo] = (np.linalg.norm(v[:, lo + 1:hi], axis=1)
                            + rng.uniform(0.1, 1.0, B))
            elif kind == "PSDTriangleConeT":
                v[:, lo:hi] = [_pd_svec(rng, c.dim) for _ in range(B)]
    if layout.has_pow:
        a = np.broadcast_to(layout.pow_alpha, (B, layout.npow))
        s1, s2 = rng.uniform(0.3, 2.0, a.shape), rng.uniform(0.3, 2.0, a.shape)
        s3 = rng.uniform(-0.9, 0.9, a.shape) * s1**a * s2**(1 - a)
        z1, z2 = rng.uniform(0.3, 2.0, a.shape), rng.uniform(0.3, 2.0, a.shape)
        z3 = (rng.uniform(-0.9, 0.9, a.shape)
              * (z1 / a)**a * (z2 / (1 - a))**(1 - a))
        s[:, layout.pow_idx] = np.stack([s1, s2, s3], -1)
        z[:, layout.pow_idx] = np.stack([z1, z2, z3], -1)
    return s, z


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, tol, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=tol,
        atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))),
        err_msg=what)


def _leaves(out, prefix=""):
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


def _hold(port_out, ref_fn, B, tol, what):
    """The port's batched result against ref_fn(i) problem by problem."""
    got = _leaves(port_out)
    for i in range(B):
        want = _leaves(ref_fn(i))
        assert set(got) == set(want), what
        for k in want:
            _close(got[k][i], want[k], tol, f"{what}[{k}] problem {i}")


def _invariants(state, layout):
    """R R', Rinv' Rinv and lambda of each PSD group: what a scaling
    update fixes, whatever the SVD's choice of U and V."""
    out = {}
    for r in layout.psd_groups:
        R = np.asarray(state[f"psd{r}_R"])
        Ri = np.asarray(state[f"psd{r}_Rinv"])
        out[f"psd{r}_RRt"] = R @ np.swapaxes(R, -1, -2)
        out[f"psd{r}_RinvtRinv"] = np.swapaxes(Ri, -1, -2) @ Ri
        out[f"psd{r}_lam"] = np.asarray(state[f"psd{r}_lam"])
    return out


# ---------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 2, 3, 5])
def test_tri_maps_and_svec(r):
    rng = np.random.default_rng(r)
    for got, want in zip(psd._tri_maps(r), ref_psd._tri_maps(r)):
        np.testing.assert_array_equal(got, want)
    g = psd.Group(r, np.arange(2 * r * (r + 1) // 2).reshape(2, -1),
                  r * (r + 1), "cpu")
    x = rng.standard_normal((3, 2, r * (r + 1) // 2))
    M = rng.standard_normal((3, 2, r, r))
    _hold(psd.svec_to_mat(_t(x), g),
          lambda i: ref_psd.svec_to_mat(jnp.asarray(x[i]), r), 3, TOL,
          "svec_to_mat")
    _hold(psd.mat_to_svec(_t(M), g),
          lambda i: ref_psd.mat_to_svec(jnp.asarray(M[i]), r), 3, TOL,
          "mat_to_svec")
    _hold(psd._skron(_t(M), g),
          lambda i: ref_psd._skron(jnp.asarray(M[i]), r), 3, TOL, "_skron")
    S = np.stack([smat(_pd_svec(rng, r), r) for _ in range(6)]).reshape(
        3, 2, r, r)
    ld, ok = psd._chol_logdet(_t(S))
    assert ok.all()
    _hold(ld, lambda i: ref_psd._chol_logdet(jnp.asarray(S[i]))[0], 3,
          TOL_DEC, "_chol_logdet")
    _close(svec(smat(x[0, 0], r)), x[0, 0], TOL, "svec(smat(x))")


# ---------------------------------------------------------------------
# the composite operations on one state
# ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(n, B) for n in LAYOUTS
                                        for B in (3, 5)],
                ids=lambda p: f"{p[0]}-B{p[1]}")
def case(request):
    name, B = request.param
    layout = build_layout(_specs(api, name))
    ref_layout = ref_build_layout(_specs(ref_api, name))
    rng = np.random.default_rng(sum(map(ord, name)) + B)
    s, z = _interior(layout, rng, B)
    mu = rng.uniform(0.5, 1.5, B)
    flag = np.arange(B) % 2
    ref_states, ref_ok = [], []
    for i in range(B):
        st_i, ok_i = ref_ops.update_scaling(
            ref_layout, jnp.asarray(s[i]), jnp.asarray(z[i]), mu[i],
            int(flag[i]))
        ref_states.append({k: np.asarray(v) for k, v in st_i.items()})
        ref_ok.append(bool(ok_i))
    m = layout.m
    return {
        "name": name, "B": B, "layout": layout, "ref_layout": ref_layout,
        "s": s, "z": z, "mu": mu, "flag": flag,
        "dz": 0.3 * rng.standard_normal((B, m)),
        "ds": 0.3 * rng.standard_normal((B, m)),
        "x": rng.standard_normal((B, m)),
        "alpha": rng.uniform(0.2, 1.0, B),
        "lo": rng.uniform(0.1, 0.4, B), "hi": rng.uniform(0.6, 2.0, B),
        "ref_states": [{k: jnp.asarray(v) for k, v in st.items()}
                       for st in ref_states], "ref_ok": ref_ok,
        "state": interop.scaling_state_from_reference(layout, ref_states),
    }


def test_update_scaling(case):
    """lambda, R R', Rinv' Rinv and Hs of the port's own scaling update
    against the reference's; the other cones' state as computed."""
    layout, B = case["layout"], case["B"]
    state, ok = ops.update_scaling(layout, _t(case["s"]), _t(case["z"]),
                                   _t(case["mu"]), _t(case["flag"]).int())
    assert ok.tolist() == case["ref_ok"] == [True] * B
    inv = _invariants(state, layout)
    for k, v in inv.items():
        _hold(v, lambda i: _invariants(case["ref_states"][i], layout)[k],
              B, TOL_DEC, f"update_scaling {k}")
    for k in state:
        if not k.startswith("psd"):
            _hold(state[k], lambda i: np.asarray(case["ref_states"][i][k]),
                  B, TOL_DEC, f"update_scaling {k}")
    _hold(ops.assemble_Hs_dense(layout, state),
          lambda i: ref_ops.assemble_Hs_dense(case["ref_layout"],
                                              case["ref_states"][i]),
          B, TOL_DEC, "Hs of the port's own scaling")


def _ref(case, i, key):
    return jnp.asarray(case[key][i])


# name -> (port, reference, tolerance)
COMPOSITE = {
    "assemble_Hs_dense": (
        lambda c: ops.assemble_Hs_dense(c["layout"], c["state"]),
        lambda c, i: ref_ops.assemble_Hs_dense(c["ref_layout"],
                                               c["ref_states"][i]), TOL),
    "mul_Hs": (
        lambda c: ops.mul_Hs(c["layout"], c["state"], _t(c["x"])),
        lambda c, i: ref_ops.mul_Hs(c["ref_layout"], c["ref_states"][i],
                                    _ref(c, i, "x")), TOL),
    "affine_ds": (
        lambda c: ops.affine_ds(c["layout"], c["state"], _t(c["s"])),
        lambda c, i: ref_ops.affine_ds(c["ref_layout"], c["ref_states"][i],
                                       _ref(c, i, "s")), TOL),
    "combined_ds_shift": (
        lambda c: ops.combined_ds_shift(
            c["layout"], c["state"], _t(c["dz"]), _t(c["ds"]),
            0.1 * _t(c["mu"]), _t(c["z"])),
        lambda c, i: ref_ops.combined_ds_shift(
            c["ref_layout"], c["ref_states"][i], _ref(c, i, "dz"),
            _ref(c, i, "ds"), 0.1 * c["mu"][i], _ref(c, i, "z")), TOL),
    "ds_from_dz_offset": (
        lambda c: ops.ds_from_dz_offset(c["layout"], c["state"],
                                        _t(c["ds"]), _t(c["z"])),
        lambda c, i: ref_ops.ds_from_dz_offset(
            c["ref_layout"], c["ref_states"][i], _ref(c, i, "ds"),
            _ref(c, i, "z")), TOL),
    "centrality_correction": (
        lambda c: ops.centrality_correction(
            c["layout"], c["state"], _t(c["z"]), _t(c["s"]), _t(c["lo"]),
            _t(c["hi"])),
        lambda c, i: ref_ops.centrality_correction(
            c["ref_layout"], c["ref_states"][i], _ref(c, i, "z"),
            _ref(c, i, "s"), c["lo"][i], c["hi"][i]), TOL_DEC),
    "step_length": (
        lambda c: ops.step_length(
            c["layout"], c["state"], _t(c["dz"]), _t(c["ds"]), _t(c["z"]),
            _t(c["s"]), _t(c["alpha"]), Settings()),
        lambda c, i: ref_ops.step_length(
            c["ref_layout"], c["ref_states"][i], _ref(c, i, "dz"),
            _ref(c, i, "ds"), _ref(c, i, "z"), _ref(c, i, "s"),
            c["alpha"][i], RefSettings()), TOL_DEC),
    "compute_barrier": (
        lambda c: ops.compute_barrier(
            c["layout"], _t(c["z"]), _t(c["s"]), _t(c["dz"]), _t(c["ds"]),
            0.5 * _t(c["alpha"])),
        lambda c, i: ref_ops.compute_barrier(
            c["ref_layout"], _ref(c, i, "z"), _ref(c, i, "s"),
            _ref(c, i, "dz"), _ref(c, i, "ds"), 0.5 * c["alpha"][i]),
        TOL_DEC),
    "margins": (
        lambda c: ops.margins(c["layout"], _t(c["x"]), ops.DUAL),
        lambda c, i: ref_ops.margins(c["ref_layout"], _ref(c, i, "x"),
                                     ref_ops.DUAL), TOL_DEC),
    "shift_to_cone_interior": (
        lambda c: ops.shift_to_cone_interior(c["layout"], _t(c["x"]),
                                             ops.PRIMAL),
        lambda c, i: ref_ops.shift_to_cone_interior(
            c["ref_layout"], _ref(c, i, "x"), ref_ops.PRIMAL), TOL_DEC),
    "scaled_unit_shift": (
        lambda c: ops.scaled_unit_shift(c["layout"], _t(c["x"]),
                                        _t(c["alpha"]), ops.PRIMAL),
        lambda c, i: ref_ops.scaled_unit_shift(
            c["ref_layout"], _ref(c, i, "x"), c["alpha"][i],
            ref_ops.PRIMAL), TOL),
    "unit_initialization": (
        lambda c: ops.unit_initialization(c["layout"], c["B"], "cpu"),
        lambda c, i: ref_ops.unit_initialization(c["ref_layout"]), TOL),
    "set_identity_scaling": (
        lambda c: ops.set_identity_scaling(c["layout"], c["B"], "cpu"),
        lambda c, i: ref_ops.set_identity_scaling(c["ref_layout"]), TOL),
}


@pytest.mark.parametrize("name", sorted(COMPOSITE))
def test_composite_matches_reference(case, name):
    port_fn, ref_fn, tol = COMPOSITE[name]
    _hold(port_fn(case), lambda i: ref_fn(case, i), case["B"], tol, name)


def test_psd_reductions_are_per_problem(case):
    """A direction that leaves one problem's PSD cone shortens that
    problem's step only, and one problem's negative eigenvalue lowers its
    own margin only: every PSD reduction runs within a problem."""
    layout = case["layout"]
    r = min(layout.psd_groups)
    lo = layout.psd_groups[r][0][0]
    ds = _t(case["ds"]).clone()
    ds[0, lo] = -1e3
    args = (_t(case["dz"]), _t(case["z"]), _t(case["s"]), _t(case["alpha"]),
            Settings())
    base = ops.step_length(layout, case["state"], args[0],
                           _t(case["ds"]), *args[1:])
    got = ops.step_length(layout, case["state"], args[0], ds, *args[1:])
    assert got[0] < base[0]
    assert torch.equal(got[1:], base[1:])
    z = _t(case["z"]).clone()
    z[0, lo] = -5.0
    a0, b0 = ops.margins(layout, _t(case["z"]), ops.DUAL)
    a1, b1 = ops.margins(layout, z, ops.DUAL)
    assert a1[0] < 0 < a0[0]
    assert torch.equal(a1[1:], a0[1:]) and torch.equal(b1[1:], b0[1:])


def test_outside_the_cone_gives_not_ok_and_big(case):
    """A point outside a PSD cone in one problem: update_scaling's ok is
    false for that problem alone and its barrier is BIG-sized, as the
    reference's, with no exception from the factorisations."""
    layout, B = case["layout"], case["B"]
    r = max(layout.psd_groups)
    lo = layout.psd_groups[r][-1][0]
    s = case["s"].copy()
    s[1, lo] = -3.0  # a negative diagonal entry: not PSD
    state, ok = ops.update_scaling(layout, _t(s), _t(case["z"]),
                                   _t(case["mu"]), _t(case["flag"]).int())
    want = [bool(ref_ops.update_scaling(
        case["ref_layout"], jnp.asarray(s[i]), jnp.asarray(case["z"][i]),
        case["mu"][i], int(case["flag"][i]))[1]) for i in range(B)]
    assert ok.tolist() == want == [i != 1 for i in range(B)]
    assert all(torch.isfinite(v).all() for v in state.values())
    zero = torch.zeros(B, dtype=torch.float64)
    barrier = ops.compute_barrier(layout, _t(case["z"]), _t(s),
                                  torch.zeros_like(_t(s)),
                                  torch.zeros_like(_t(s)), zero)
    ref1 = ref_ops.compute_barrier(case["ref_layout"],
                                   jnp.asarray(case["z"][1]),
                                   jnp.asarray(s[1]),
                                   jnp.zeros(layout.m), jnp.zeros(layout.m),
                                   0.0)
    assert float(barrier[1]) >= psd.BIG / 2
    np.testing.assert_allclose(float(barrier[1]), float(ref1), rtol=1e-12)


def test_non_finite_input_raises_nothing():
    """A NaN step reaches the eigen-solvers of the step length as the
    reference's NaN does: its problem's PSD limit is then no limit, and
    the others are untouched."""
    layout = build_layout(_specs(api, "psd_only"))
    rng = np.random.default_rng(0)
    s, z = _interior(layout, rng, 3)
    state, ok = ops.update_scaling(layout, _t(s), _t(z), 1.0, 0)
    dz = _t(0.3 * rng.standard_normal(s.shape))
    ds = dz.clone()
    ds[2, 0] = float("nan")
    one = torch.ones(3, dtype=torch.float64)
    base = ops.step_length(layout, state, dz, dz.clone(), _t(z), _t(s), one,
                           Settings())
    got = ops.step_length(layout, state, dz, ds, _t(z), _t(s), one,
                          Settings())
    assert torch.equal(got[:2], base[:2])
    assert bool(torch.isfinite(got[2]))


def test_interop_checks_the_psd_cone_counts():
    layout = build_layout(_specs(api, "psd_only"))
    eye = np.broadcast_to(np.eye(2), (2, 2, 2))  # two cones of side 2
    bad = {"psd2_R": eye, "psd2_Rinv": eye, "psd2_lam": np.ones((2, 2))}
    with pytest.raises(ValueError):
        interop.scaling_state_from_reference(layout, [bad])
