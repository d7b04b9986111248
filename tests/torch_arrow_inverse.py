"""How the block-arrow KKT's saddle inverse holds up on the box-and-budget
QP of `problems.box_budget_qp(N, M_IN, SEED)` (ROADMAP F12): the solve's
status, iterations and residuals under each inverse rule, and, per
factorization, the residual max|M X - I| of the pivot-free inverse and of
pivoted LU's beside the saddle's condition number.

    PYTHONPATH=. python tests/torch_arrow_inverse.py M_IN [--n N]
        [--seed SEED] [--device cpu|cuda] [--rules guard,pivotfree,lu]
        [--residuals] [--reference]

(`python -m tests.torch_arrow_inverse` from the root works too where no
installed package is named `tests`.)

Rules: "guard", the port's (`kkt/arrow.py::saddle_inverse`: pivoted LU
where the pivot-free inverse's residual exceeds 1e-2); "pivotfree", the
reference's inverse alone; "lu", pivoted LU alone.  --residuals prints
the per-factorization residuals of the first rule's solve (three extra
inverses a factorization); --reference also solves with the reference's
ShardedSolver (CPU, imports the JAX package; with JAX_PLATFORMS=cpu).
Prints one JSON line per solve."""

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("m_in", type=int)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--rules", default="guard,pivotfree")
    ap.add_argument("--residuals", action="store_true")
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args(argv)

    import cuclarabel_torch as ct
    from cuclarabel_torch.kkt import arrow
    from cuclarabel_torch.kkt.dense import pivotfree_inv
    from cuclarabel_torch.problems import box_budget_qp

    data = box_budget_qp(args.n, args.m_in, args.seed)
    rules = {
        "guard": arrow.saddle_inverse,
        "pivotfree": pivotfree_inv,
        "lu": lambda M: torch.linalg.inv_ex(M)[0],
    }
    card = (torch.cuda.get_device_name(0) if args.device != "cpu"
            else "cpu")
    for k, name in enumerate(args.rules.split(",")):
        rule = rules[name]
        rows = []

        def traced(M, rule=rule, rows=rows):
            eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
            res = lambda X: float((M @ X - eye).abs().max())  # noqa: E731
            rows.append({"pivotfree": res(pivotfree_inv(M)),
                         "lu": res(torch.linalg.inv_ex(M)[0]),
                         "cond": float(torch.linalg.cond(M))})
            return rule(M)

        arrow.saddle_inverse = traced if args.residuals and k == 0 else rule
        arrow.SADDLE_INVERSES.clear()
        try:
            t0 = time.perf_counter()
            sol = ct.ShardedSolver(*data, device=args.device).solve()
            seconds = time.perf_counter() - t0
        finally:
            arrow.saddle_inverse = rules["guard"]
        out = {"rule": name, "n": args.n, "m": args.m_in + 1,
               "device": card, "status": sol.status.name,
               "iterations": sol.iterations, "r_prim": sol.r_prim,
               "r_dual": sol.r_dual, "obj_val": sol.obj_val,
               "seconds": seconds}
        if name == "guard":
            out["inverses_kept"] = dict(arrow.SADDLE_INVERSES)
        if rows:
            out["residuals"] = rows
        print(json.dumps(out), flush=True)
    if args.reference:
        import cuclarabel_tpu as cc
        from cuclarabel_tpu.parallel import ShardedSolver as RefSharded

        P, q, A, b, _ = data
        cones = [cc.ZeroConeT(1), cc.NonnegativeConeT(args.m_in)]
        t0 = time.perf_counter()
        sol = RefSharded(P, q, A, b, cones).solve()
        print(json.dumps({"rule": "reference", "n": args.n,
                          "m": args.m_in + 1, "device": "cpu",
                          "status": sol.status.name,
                          "iterations": sol.iterations,
                          "r_prim": sol.r_prim, "r_dual": sol.r_dual,
                          "obj_val": float(np.asarray(sol.obj_val)),
                          "seconds": time.perf_counter() - t0}),
              flush=True)


if __name__ == "__main__":
    main()
