"""The benchmark's control: the plain reference computed in float32,
the precision below the configuration's float64, put in the program's
place and judged by the same check (`harness.check`).  It must come out
not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the first `--batches` window batches of the cell's data,
at the cell's size, from which SAMPLE_RANDOM + SAMPLE_HARDEST problems
are drawn from the seed (as many as a run solves again), each solved by
the float32 reference, whose answers claim SOLVED.  Prints one JSON
line per seed with the numbers the check compares and their limits.
Needs no card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import generators, harness  # noqa: E402


class Answer:
    """A reference answer in the shape of the program's."""

    class status:
        name = "SOLVED"

    def __init__(self, r):
        self.x, self.s, self.z = r["x"], r["s"], r["z"]
        self.iterations = r["iterations"]


def control_results(cell, seed, batches, dtype=np.float32):
    """(results, struct): the sampled problems of the first `batches`
    window batches, answered by the reference in `dtype`."""
    cfg, gen = cell.config, cell.generator
    struct = gen.structure(cfg)
    width = int(cell.traffic["batch"])
    data = [gen.batch(cfg, struct, generators.rng(seed, generators.WINDOW, k),
                      width) for k in range(batches)]
    total = batches * width
    want = min(total, harness.SAMPLE_RANDOM + harness.SAMPLE_HARDEST)
    rng = generators.rng(seed, generators.SAMPLE, 0)
    picks = sorted(rng.choice(total, size=want, replace=False))
    sub = {"q": [], "b": []}
    answers = []
    for f in picks:
        d = data[f // width]
        i = f % width
        sub["q"].append(d["q"][i])
        sub["b"].append(d["b"][i])
        answers.append(Answer(cell.reference.solve(
            struct["P"], d["q"][i], struct["A"], d["b"][i], struct["cones"],
            dtype=dtype)))
    sub = {k: np.stack(v) for k, v in sub.items()}
    return [(sub, answers)], struct


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=2)
    args = ap.parse_args(argv)
    cell = harness.Cell(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        results, struct = control_results(cell, seed, args.batches)
        checks, attempted, _ = harness.check(cell, struct, results, seed)
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": "reference in float32",
                          "compared": attempted, "correct": correct,
                          "seconds": time.perf_counter() - t0,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
