"""How many `problems.exp_logistic(4, 10, B, seed)` problems end
ALMOST_SOLVED, and how many under Dual scaling, in the reference's and
the port's batches on the CPU (ROADMAP F8).

    JAX_PLATFORMS=cpu python -m tests.torch_f8_rates PIPELINE [B] [SEED]
        [--unregularised] [--exact-residual]

PIPELINE: ref-lu, ref-pallas (the reference's kernels in interpret mode,
about 5 minutes at B = 300), port-pallas (the plain LDL^T kernels) or
port-lu.  --unregularised: the port refines against the unregularised
K, as the reference does; --exact-residual: the port's plain residual
is summed exactly (Ogita-Rump-Oishi Dot2).  Prints one line: statuses,
the Dual-scaled count, mean and max iterations, the ALMOST_SOLVED
problems and the seconds taken."""

import argparse
import collections
import time

import numpy as np
import torch


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    def split(v):
        c = 134217729.0 * v  # 2^27 + 1
        hi = c - (c - v)
        return hi, v - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def exact_residual(K, x, b):
    """b - K x with K (B, N, N), x and b (B, N) or (B, N, R), accurate to
    the last bit of the result (Dot2 with b as the first term)."""
    xr = x.unsqueeze(-1) if x.dim() == 2 else x
    s = (b.unsqueeze(-1) if b.dim() == 2 else b).clone()
    c = torch.zeros_like(s)
    for k in range(K.shape[2]):
        p, ep = _two_prod(K[:, :, k, None], xr[:, k, None, :])
        s, es = _two_sum(s, -p)
        c = c + (es - ep)
    return (s + c).reshape(b.shape)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pipeline", choices=("ref-lu", "ref-pallas",
                                         "port-pallas", "port-lu"))
    ap.add_argument("B", nargs="?", type=int, default=300)
    ap.add_argument("seed", nargs="?", type=int, default=1000)
    ap.add_argument("--unregularised", action="store_true")
    ap.add_argument("--exact-residual", action="store_true")
    a = ap.parse_args(argv)
    from cuclarabel_torch.problems import exp_logistic

    P, qs, A, bs, cones = exp_logistic(4, 10, a.B, a.seed)
    t = time.time()
    if a.pipeline.startswith("ref"):
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import cuclarabel_tpu as cc
        from cuclarabel_tpu.parallel import BatchSolver

        rcones = [cc.NonnegativeConeT(10)] + [cc.ExponentialConeT()] * 20
        solver = BatchSolver(P, qs, A, bs, rcones,
                             kkt_solve_method=a.pipeline[4:])
    else:
        import cuclarabel_torch as ct
        from cuclarabel_torch.kkt import dense, ldl

        if a.unregularised:
            dense.refines_regularised = lambda layout: False
        if a.exact_residual:
            ldl._residual = exact_residual
        solver = ct.BatchSolver(P, qs, A, bs, cones, device="cpu",
                                kkt_solve_method=a.pipeline[5:])
    sols = solver.solve()
    status = collections.Counter(s.status.name for s in sols)
    iters = np.array([s.iterations for s in sols])
    dual = int(np.asarray(solver.raw["scaling"]).sum())
    almost = [i for i, s in enumerate(sols) if s.status.name != "SOLVED"]
    print(f"{a.pipeline} B={a.B} seed={a.seed}"
          f"{' unregularised' if a.unregularised else ''}"
          f"{' exact-residual' if a.exact_residual else ''}: "
          f"{dict(status)}, Dual {dual}, iterations mean {iters.mean():.2f} "
          f"max {iters.max()}, not SOLVED {almost}, "
          f"{time.time() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
