"""How many `problems.exp_logistic(4, 10, B, seed)` problems end
ALMOST_SOLVED, and how many under Dual scaling, in the reference's and
the port's batches on the CPU (ROADMAP F8); with --family maxcut the same
for `problems.maxcut_sdp(NV, B, seed)`, and with --warm MULT for a
re-solve warm-started from the cold solutions after update_data(q=MULT q)
(ROADMAP F11).  With --family portfolio, `problems.portfolio_socp(NASS,
B, seed)`; with --seg-order padded, the second-order cones' segment
sums are taken as one sum over a padded, zero-masked axis instead of in
ascending order (on both sides), so that a knife-edge problem shows
whether it turns on the order of those sums alone (ROADMAP F15).

    JAX_PLATFORMS=cpu python -m tests.torch_f8_rates PIPELINE [B] [SEED]
        [--unregularised] [--exact-residual] [--regularised]
        [--family maxcut|portfolio] [--nv NV] [--nass NASS] [--warm MULT]
        [--seg-order padded]

PIPELINE: ref-lu, ref-pallas (the reference's kernels in interpret mode,
about 5 minutes at B = 300), port-pallas (the plain LDL^T kernels) or
port-lu.  --unregularised: the port refines against the unregularised
K, as the reference does; --exact-residual: the port's plain residual
is summed as if in twice the precision (`chip_smoke.kkt_residual_exact`,
Ogita-Rump-Oishi Dot2); --regularised: the port
refines against the regularised K on every layout (on symmetric layouts
it keeps the reference's rule).  Prints one line: statuses,
the Dual-scaled count, mean and max iterations, the ALMOST_SOLVED
problems and the seconds taken."""

import argparse
import collections
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pipeline", choices=("ref-lu", "ref-pallas",
                                         "port-pallas", "port-lu"))
    ap.add_argument("B", nargs="?", type=int, default=300)
    ap.add_argument("seed", nargs="?", type=int, default=1000)
    ap.add_argument("--unregularised", action="store_true")
    ap.add_argument("--exact-residual", action="store_true")
    ap.add_argument("--regularised", action="store_true")
    ap.add_argument("--family", choices=("exp_logistic", "maxcut",
                                         "portfolio"),
                    default="exp_logistic")
    ap.add_argument("--nv", type=int, default=12)
    ap.add_argument("--nass", type=int, default=32)
    ap.add_argument("--warm", type=float, default=None)
    ap.add_argument("--seg-order", choices=("ascending", "padded"),
                    default="ascending")
    a = ap.parse_args(argv)
    from cuclarabel_torch import problems

    if a.family == "maxcut":
        P, qs, A, bs, cones, _ = problems.maxcut_sdp(a.nv, a.B, a.seed)
    elif a.family == "portfolio":
        P = None
        A, qs, bs, cones = problems.portfolio_socp(a.nass, a.B, a.seed)
    else:
        P, qs, A, bs, cones = problems.exp_logistic(4, 10, a.B, a.seed)
    t = time.time()
    if a.pipeline.startswith("ref"):
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import cuclarabel_tpu as cc
        from cuclarabel_tpu.parallel import BatchSolver

        if a.seg_order == "padded":
            _padded_ref_seg_sum()
        rcones = [getattr(cc, type(c).__name__)(
            *((c.dim,) if hasattr(c, "dim") else ())) for c in cones]
        solver = BatchSolver(P, qs, A, bs, rcones,
                             kkt_solve_method=a.pipeline[4:])
    else:
        import cuclarabel_torch as ct
        from cuclarabel_torch.kkt import dense, ldl

        if a.unregularised:
            dense.refines_regularised = lambda layout: False
        if a.regularised:
            dense.refines_regularised = lambda layout: True
        if a.exact_residual:
            from chip_smoke import kkt_residual_exact
            ldl._residual = kkt_residual_exact
        if a.seg_order == "padded":
            _padded_port_seg_sum()
        solver = ct.BatchSolver(P, qs, A, bs, cones, device="cpu",
                                kkt_solve_method=a.pipeline[5:])
    sols = solver.solve()
    if a.warm is not None:
        solver.update_data(q=a.warm * qs)
        sols = solver.solve(warm_start=tuple(
            np.stack([getattr(s, f) for s in sols]) for f in ("x", "s", "z")))
    status = collections.Counter(s.status.name for s in sols)
    iters = np.array([s.iterations for s in sols])
    dual = int(np.asarray(solver.raw["scaling"]).sum())
    almost = [i for i, s in enumerate(sols) if s.status.name != "SOLVED"]
    print(f"{a.family} {a.pipeline} B={a.B} seed={a.seed}"
          f"{f' nv={a.nv}' if a.family == 'maxcut' else ''}"
          f"{f' nass={a.nass}' if a.family == 'portfolio' else ''}"
          f" segment sums {a.seg_order}"
          f"{f' warm after q x {a.warm}' if a.warm is not None else ''}"
          f"{' regularised' if a.regularised else ''}"
          f"{' unregularised' if a.unregularised else ''}"
          f"{' exact-residual' if a.exact_residual else ''}: "
          f"{dict(status)}, Dual {dual}, iterations mean {iters.mean():.2f} "
          f"max {iters.max()}, not SOLVED {almost}, "
          f"{time.time() - t:.1f} s", flush=True)


def _padded(starts, dims):
    """Each cone's positions in the gathered vector, padded with 0, and
    the mask of the real ones: (nsoc, longest cone) each."""
    k = np.arange(int(dims.max()))
    mask = k[None, :] < dims[:, None]
    return np.where(mask, starts[:, None] + k[None, :], 0), mask


def _padded_ref_seg_sum():
    import jax.numpy as jnp
    from cuclarabel_tpu.cones import ops

    def seg_sum(layout, vals):
        pad, mask = _padded(np.asarray(layout.soc_headpos, np.int64),
                            np.asarray(layout.soc_dims, np.int64))
        return jnp.where(mask, vals[..., pad], 0.0).sum(axis=-1)

    ops._seg_sum = seg_sum


def _padded_port_seg_sum():
    import torch
    from cuclarabel_torch.cones import ops

    def seg_sum(layout, vals):
        pad, mask = _padded(layout.soc_headpos.astype(np.int64),
                            layout.soc_dims.astype(np.int64))
        return torch.where(torch.as_tensor(mask), vals[:, pad],
                           0.0).sum(dim=-1)

    ops._seg_sum = seg_sum


if __name__ == "__main__":
    main()
