"""Run one cell of the benchmark once, on the CUDA card, and print its
result as one JSON line, the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

--trace 0 measures the end-to-end metrics over a window of --seconds;
--trace 1 profiles the cell's batches and reports its per-layer
metrics.  Both check every answer (`harness.check`) and print each
number compared beside its limit, as the last lines of standard error
and under "checks", the last key of the JSON line.  Exits non-zero and
prints no result without a CUDA card, or where jax, jaxlib, flax or
cuclarabel_tpu was loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the host side of a run is one Python
# thread launching work; idle BLAS and OpenMP pools only add noise
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
sys.path = [p for p in sys.path if Path(p or ".").resolve() !=
            Path(__file__).resolve().parent]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    cell = harness.Cell(ROOT, args.workload)
    import torch
    torch.set_num_threads(1)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(f"portbench: card {harness.card_line()}", flush=True)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
