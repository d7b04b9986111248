"""The port's nonsymmetric cones (cuclarabel_torch/cones/{nonsymmetric,exp,
pow,genpow}.py and their dispatch in cones/ops.py) against the
reference's (cuclarabel_tpu/cones/...) on the same inputs.

Inputs are seeded numpy interior points of B = 3 and B = 5 problems with
1 to 6 cones of each type.  The reference functions take one problem and
are called per problem (never vmapped: ROADMAP F2); the port takes the
batch.  The composite operations run on one and the same scaling state,
the reference's, carried across with
`interop.scaling_state_from_reference`.  Tolerance: 1e-12 relative,
atol 1e-12 x max|ref|; the outputs of the Newton solves 1e-11."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuclarabel_tpu.cones.api as ref_api
from cuclarabel_tpu.cones import exp as ref_exp
from cuclarabel_tpu.cones import genpow as ref_gp
from cuclarabel_tpu.cones import nonsymmetric as ref_ns
from cuclarabel_tpu.cones import ops as ref_ops
from cuclarabel_tpu.cones import pow as ref_pow
from cuclarabel_tpu.cones.layout import build_layout as ref_build_layout
from cuclarabel_tpu.settings import Settings as RefSettings
from cuclarabel_torch import interop
from cuclarabel_torch.cones import api, exp, genpow, nonsymmetric as ns, ops
from cuclarabel_torch.cones import pow
from cuclarabel_torch.cones.layout import build_layout
from cuclarabel_torch.settings import Settings

TOL = 1e-12
TOL_NEWTON = 1e-11
# (name, zero, nn, soc dims, exp count, pow alphas, genpow (alpha, dim2))
LAYOUTS = {
    "one_each": (1, 2, (3,), 1, (0.6,), (((0.3, 0.7), 1),)),
    "many": (2, 3, (4, 3), 6, (0.1, 0.35, 0.5, 0.8, 0.9, 0.6),
             (((0.2, 0.3, 0.5), 2), ((0.6, 0.4), 1), ((0.25, 0.75), 3),
              ((0.1, 0.9), 1))),
    "nonsym_only": (0, 0, (), 3, (0.3, 0.7), (((0.5, 0.5), 2),)),
}


def _specs(mod, name):
    zero, nn, socs, nexp, alphas, gps = LAYOUTS[name]
    cones = []
    if zero:
        cones.append(mod.ZeroConeT(zero))
    if nn:
        cones.append(mod.NonnegativeConeT(nn))
    cones += [mod.SecondOrderConeT(d) for d in socs]
    cones += [mod.ExponentialConeT() for _ in range(nexp)]
    cones += [mod.PowerConeT(a) for a in alphas]
    cones += [mod.GenPowerConeT(list(a), d2) for a, d2 in gps]
    return tuple(cones)


def _exp_points(rng, shape):
    """(primal s, dual z) interior points of exp cones, shape + (3,)."""
    s2, s3 = rng.uniform(0.3, 2.0, shape), rng.uniform(0.3, 2.0, shape)
    s1 = s2 * np.log(s3 / s2) - rng.uniform(0.1, 2.0, shape)
    z1, z3 = -rng.uniform(0.3, 2.0, shape), rng.uniform(0.3, 2.0, shape)
    z2 = z1 + z1 * np.log(-z3 / z1) + rng.uniform(0.1, 2.0, shape)
    return np.stack([s1, s2, s3], -1), np.stack([z1, z2, z3], -1)


def _pow_points(rng, a):
    """(s, z) interior points of pow cones with exponents a (..., k)."""
    s1, s2 = rng.uniform(0.3, 2.0, a.shape), rng.uniform(0.3, 2.0, a.shape)
    sgn = rng.choice([-1.0, 1.0], a.shape)
    s3 = sgn * rng.uniform(0.0, 0.9, a.shape) * s1**a * s2**(1 - a)
    z1, z2 = rng.uniform(0.3, 2.0, a.shape), rng.uniform(0.3, 2.0, a.shape)
    z3 = (-sgn * rng.uniform(0.0, 0.9, a.shape)
          * (z1 / a)**a * (z2 / (1 - a))**(1 - a))
    return np.stack([s1, s2, s3], -1), np.stack([z1, z2, z3], -1)


def _interior(layout, rng, B):
    """(s, z) (B, m), strictly inside every cone of `layout`."""
    m = layout.m
    s, z = rng.standard_normal((B, m)), rng.standard_normal((B, m))
    for v in (s, z):
        v[:, layout.nn_mask] = rng.uniform(0.2, 2.0,
                                           (B, layout.nn_mask.sum()))
    for c, (lo, hi) in zip(layout.specs, layout.ranges):
        if type(c).__name__ == "SecondOrderConeT":
            for v in (s, z):
                v[:, lo] = (np.linalg.norm(v[:, lo + 1:hi], axis=1)
                            + rng.uniform(0.1, 1.0, B))
    if layout.has_exp:
        se, ze = _exp_points(rng, (B, layout.nexp))
        s[:, layout.exp_idx], z[:, layout.exp_idx] = se, ze
    if layout.has_pow:
        sp, zp = _pow_points(rng, np.broadcast_to(layout.pow_alpha,
                                                  (B, layout.npow)))
        s[:, layout.pow_idx], z[:, layout.pow_idx] = sp, zp
    for i, (c, (lo, hi)) in enumerate(
            (c, r) for c, r in zip(layout.specs, layout.ranges)
            if type(c).__name__ == "GenPowerConeT"):
        a = np.asarray(c.alpha)
        d1 = len(a)
        for v, dual in ((s, False), (z, True)):
            u = rng.uniform(0.3, 2.0, (B, d1))
            w = rng.standard_normal((B, c.dim2))
            lim = np.prod((u / a if dual else u) ** a, axis=1)
            w *= (rng.uniform(0.1, 0.9, B) * lim
                  / np.linalg.norm(w, axis=1))[:, None]
            v[:, lo:lo + d1], v[:, lo + d1:hi] = u, w
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


# ---------------------------------------------------------------------
# the cone functions
# ---------------------------------------------------------------------

@pytest.mark.parametrize("B", [3, 5])
def test_wright_omega(B):
    rng = np.random.default_rng(B)
    z = np.concatenate([rng.uniform(1.0, 1.0 + np.pi, (B, 4)),
                        rng.uniform(1.0 + np.pi, 60.0, (B, 3))], axis=1)
    _hold(exp._wright_omega(_t(z)),
          lambda i: ref_exp._wright_omega(jnp.asarray(z[i])), B, TOL,
          "wright_omega")


@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("B", [3, 5])
def test_exp_cone_functions(B, k):
    rng = np.random.default_rng(10 * B + k)
    s, z = _exp_points(rng, (B, k))
    ds, v = rng.standard_normal((B, k, 3)), rng.standard_normal((B, k, 3))
    grad, H = exp._dual_grad_H(_t(z))
    ref = [ref_exp._dual_grad_H(jnp.asarray(z[i])) for i in range(B)]
    _hold((grad, H), lambda i: ref[i], B, TOL, "exp _dual_grad_H")
    _hold(exp._gradient_primal(_t(s)),
          lambda i: ref_exp._gradient_primal(jnp.asarray(s[i])), B, TOL,
          "exp _gradient_primal")
    _hold(exp._higher_correction(H, _t(z), _t(ds), _t(v)),
          lambda i: ref_exp._higher_correction(
              ref[i][1], jnp.asarray(z[i]), jnp.asarray(ds[i]),
              jnp.asarray(v[i])), B, TOL, "exp _higher_correction")
    for name in ("_barrier_dual", "_is_dual_feasible"):
        _hold(getattr(exp, name)(_t(z)),
              lambda i: getattr(ref_exp, name)(jnp.asarray(z[i])), B, TOL,
              f"exp {name}")
    for name in ("_barrier_primal", "_is_primal_feasible"):
        _hold(getattr(exp, name)(_t(s)),
              lambda i: getattr(ref_exp, name)(jnp.asarray(s[i])), B, TOL,
              f"exp {name}")


@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("B", [3, 5])
def test_pow_cone_functions(B, k):
    rng = np.random.default_rng(20 * B + k)
    a = rng.uniform(0.05, 0.95, k)
    s, z = _pow_points(rng, np.broadcast_to(a, (B, k)))
    s[0, 0, 2] = 0.0  # the |s3| <= eps branch of the primal gradient
    ds, v = rng.standard_normal((B, k, 3)), rng.standard_normal((B, k, 3))
    at = _t(a)
    aj = jnp.asarray(a)
    grad, H = pow._dual_grad_H(_t(z), at)
    ref = [ref_pow._dual_grad_H(jnp.asarray(z[i]), aj) for i in range(B)]
    _hold((grad, H), lambda i: ref[i], B, TOL, "pow _dual_grad_H")
    _hold(pow._gradient_primal(_t(s), at),
          lambda i: ref_pow._gradient_primal(jnp.asarray(s[i]), aj), B,
          TOL_NEWTON, "pow _gradient_primal")
    _hold(pow._barrier_primal(_t(s), at),
          lambda i: ref_pow._barrier_primal(jnp.asarray(s[i]), aj), B,
          TOL_NEWTON, "pow _barrier_primal")
    _hold(pow._barrier_dual(_t(z), at),
          lambda i: ref_pow._barrier_dual(jnp.asarray(z[i]), aj), B, TOL,
          "pow _barrier_dual")
    _hold(pow._higher_correction(H, _t(z), at, _t(ds), _t(v)),
          lambda i: ref_pow._higher_correction(
              ref[i][1], jnp.asarray(z[i]), aj, jnp.asarray(ds[i]),
              jnp.asarray(v[i])), B, TOL, "pow _higher_correction")


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("B", [3, 5])
def test_exp_pd_scaling(B, k):
    """primal_dual_scaling_3x3 off the central path, and its fallback to
    mu H on it (tests/test_nonsym_units.py::
    test_pd_scaling_falls_back_on_central_path)."""
    rng = np.random.default_rng(30 * B + k)
    s, z = _exp_points(rng, (B, k))
    mu = rng.uniform(0.1, 2.0, (B, k))
    st, H = exp._dual_grad_H(_t(z))
    central = -_t(mu)[..., None] * st  # s = -mu grad f*(z): on the path
    for pts, what in ((_t(s), "generic"), (central, "central")):
        zt = exp._gradient_primal(pts)
        got = ns.primal_dual_scaling_3x3(pts, _t(z), st, zt, H)

        def ref(i):
            zj = jnp.asarray(z[i])
            gi, Hi = ref_exp._dual_grad_H(zj)
            si = jnp.asarray(pts[i].numpy())
            return ref_ns.primal_dual_scaling_3x3(
                si, zj, gi, ref_exp._gradient_primal(si), Hi)

        _hold(got, ref, B, TOL, f"primal_dual_scaling_3x3 {what}")
        if what == "central":
            mu_eff = (central * _t(z)).sum(-1) / 3.0
            np.testing.assert_allclose(
                got.numpy(), (mu_eff[..., None, None] * H).numpy(),
                rtol=1e-6)


def test_newton_and_backtrack_are_per_problem():
    """The masked loops freeze each (problem, cone) on its own: problem 1
    holds nothing of problem 0's step count, so each row's result is the
    one it gets alone."""
    f0 = lambda x: 1.0 / x - 0.5  # noqa: E731  (convex, root 2)
    f1 = lambda x: -1.0 / (x * x)  # noqa: E731
    x0 = _t([[0.5, 1.0], [1.9, 1.99]])
    x = ns.newton_raphson_onesided(x0, f0, f1)
    # the last step, below sqrt(eps) relative, is not taken
    np.testing.assert_allclose(x.numpy(), 2.0, rtol=1e-7)
    for i in range(2):
        assert torch.equal(ns.newton_raphson_onesided(x0[i:i + 1], f0, f1),
                           x[i:i + 1])
    st = Settings()
    a = ns.backtrack_alpha(_t([1.0, 1.0, 1.0]),
                           lambda a: a <= _t([1.0, 0.5, 1e-20]), st)
    step = 1.0
    for _ in range(4):  # 0.8^3 > 0.5 >= 0.8^4
        step *= st.linesearch_backtrack_step
    assert a.tolist() == [1.0, step, 0.0]


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
    flag = np.arange(B) % 2  # PrimalDual and Dual scaling side by side
    ref_states = []
    ref_ok = []
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
        "ref_states": [{k: jnp.asarray(v) for k, v in st.items()}
                       for st in ref_states], "ref_ok": ref_ok,
        "state": interop.scaling_state_from_reference(layout, ref_states),
    }


def test_update_scaling(case):
    layout, B = case["layout"], case["B"]
    state, ok = ops.update_scaling(layout, _t(case["s"]), _t(case["z"]),
                                   _t(case["mu"]), _t(case["flag"]).int())
    assert ok.tolist() == case["ref_ok"]
    for k, want in case["state"].items():
        tol = TOL_NEWTON if k.startswith(("pow_Hs", "gp_")) else TOL
        _hold(state[k], lambda i: np.asarray(case["ref_states"][i][k]), B,
              tol,
              f"update_scaling {k}")


def _ref(case, i, key):
    return jnp.asarray(case[key][i])


COMPOSITE = {
    "assemble_Hs_dense": (
        lambda c: ops.assemble_Hs_dense(c["layout"], c["state"]),
        lambda c, i: ref_ops.assemble_Hs_dense(c["ref_layout"],
                                               c["ref_states"][i])),
    "mul_Hs": (
        lambda c: ops.mul_Hs(c["layout"], c["state"], _t(c["x"])),
        lambda c, i: ref_ops.mul_Hs(c["ref_layout"], c["ref_states"][i],
                                    _ref(c, i, "x"))),
    "affine_ds": (
        lambda c: ops.affine_ds(c["layout"], c["state"], _t(c["s"])),
        lambda c, i: ref_ops.affine_ds(c["ref_layout"], c["ref_states"][i],
                                       _ref(c, i, "s"))),
    "combined_ds_shift": (
        lambda c: ops.combined_ds_shift(
            c["layout"], c["state"], _t(c["dz"]), _t(c["ds"]),
            0.1 * _t(c["mu"]), _t(c["z"])),
        lambda c, i: ref_ops.combined_ds_shift(
            c["ref_layout"], c["ref_states"][i], _ref(c, i, "dz"),
            _ref(c, i, "ds"), 0.1 * c["mu"][i], _ref(c, i, "z"))),
    "ds_from_dz_offset": (
        lambda c: ops.ds_from_dz_offset(c["layout"], c["state"],
                                        _t(c["ds"]), _t(c["z"])),
        lambda c, i: ref_ops.ds_from_dz_offset(
            c["ref_layout"], c["ref_states"][i], _ref(c, i, "ds"),
            _ref(c, i, "z"))),
    "step_length": (
        lambda c: ops.step_length(
            c["layout"], c["state"], _t(c["dz"]), _t(c["ds"]), _t(c["z"]),
            _t(c["s"]), _t(c["alpha"]), Settings()),
        lambda c, i: ref_ops.step_length(
            c["ref_layout"], c["ref_states"][i], _ref(c, i, "dz"),
            _ref(c, i, "ds"), _ref(c, i, "z"), _ref(c, i, "s"),
            c["alpha"][i], RefSettings())),
    "compute_barrier": (
        lambda c: ops.compute_barrier(
            c["layout"], _t(c["z"]), _t(c["s"]), _t(c["dz"]), _t(c["ds"]),
            0.5 * _t(c["alpha"])),
        lambda c, i: ref_ops.compute_barrier(
            c["ref_layout"], _ref(c, i, "z"), _ref(c, i, "s"),
            _ref(c, i, "dz"), _ref(c, i, "ds"), 0.5 * c["alpha"][i])),
    "unit_initialization": (
        lambda c: ops.unit_initialization(c["layout"], c["B"], "cpu"),
        lambda c, i: ref_ops.unit_initialization(c["ref_layout"])),
    "set_identity_scaling": (
        lambda c: ops.set_identity_scaling(c["layout"], c["B"], "cpu"),
        lambda c, i: ref_ops.set_identity_scaling(c["ref_layout"])),
}


@pytest.mark.parametrize("name", sorted(COMPOSITE))
def test_composite_matches_reference(case, name):
    port_fn, ref_fn = COMPOSITE[name]
    tol = TOL_NEWTON if name == "compute_barrier" else TOL
    _hold(port_fn(case), lambda i: ref_fn(case, i), case["B"], tol, name)


def test_step_length_is_per_problem(case):
    """One problem's infeasible direction shortens its own step only:
    alpha is reduced over that problem's cones, never over the batch."""
    layout = case["layout"]
    dz = _t(case["dz"]).clone()
    ds = _t(case["ds"]).clone()
    base = ops.step_length(layout, case["state"], dz, ds, _t(case["z"]),
                           _t(case["s"]), _t(case["alpha"]), Settings())
    idx = layout.exp_idx[0] if layout.has_exp else layout.gp_idx1[0]
    ds[0, idx] = -50.0 * _t(case["s"])[0, idx].abs() - 50.0
    got = ops.step_length(layout, case["state"], dz, ds, _t(case["z"]),
                          _t(case["s"]), _t(case["alpha"]), Settings())
    assert got[0] < base[0]
    assert torch.equal(got[1:], base[1:])


def test_genpow_gradient_primal(case):
    layout = case["layout"]  # every layout of LAYOUTS has genpow cones
    p = ops.plan(layout, "cpu")
    u, w = genpow._gather(p, _t(case["s"]))
    _hold(genpow._gradient_primal(p, u, w),
          lambda i: ref_gp._gradient_primal(
              case["ref_layout"], *ref_gp._gather(case["ref_layout"],
                                                  _ref(case, i, "s"))),
          case["B"], TOL_NEWTON, "genpow _gradient_primal")
