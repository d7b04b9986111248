"""One run of one cell: set-up, a closed loop over the window, the
check of every answer, and one JSON line of results.

Everything a cell needs is found by name from files:

- the cell's entry in BENCHMARK.json, and `workloads/<cell>.json`: the
  layers its traced run wraps;
- its configuration's file (BENCHMARK.json's "file"), whose "generator"
  names `generators/<generator>.py` and whose "reference" names
  `reference/<reference>.py`, the plain reference that the check uses;
- its traffic, `traffic/<traffic>.json`: parameters (batch width,
  solver settings, profiled batches) and the "driver" that reads them,
  `drivers/<driver>.py`, the one piece of code that calls the program;
- `layers/<layer>.json`: the entry points the traced run wraps;
- `metrics/<metric>.py`: the reader of each per-layer metric, a
  function `read(record)` that returns a number, or None where the
  record holds nothing for it.

The closed loop: group k of the window draws its data from (seed, k)
and is served by the driver; the next starts when it returns.  Set-up
is the driver's construction: the program built at the cell's shape and
warmed up on data drawn from a stream of its own.
"""

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import generators, yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "cuclarabel_tpu")
# the answers that the plain reference solves again: drawn from the seed,
# and those that took the most iterations
SAMPLE_RANDOM = 16
SAMPLE_HARDEST = 8


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell as the files under `root` define it."""

    def __init__(self, root, name):
        root = Path(root)
        self.root = root
        self.bench = root / "portbench"
        manifest = load_json(root / "BENCHMARK.json")
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        spec = load_json(self.bench / "workloads" / f"{name}.json")
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        gname = self.config["generator"]
        self.generator = load_module(
            self.bench / "generators" / f"{gname}.py",
            f"portbench.generators.{gname}")
        rname = self.config["reference"]
        self.reference = load_module(
            self.bench / "reference" / f"{rname}.py",
            f"portbench.reference.{rname}")
        self.traffic = load_json(
            self.bench / "traffic" / f"{self.entry['traffic']}.json")
        dname = self.traffic["driver"]
        self.driver = load_module(self.bench / "drivers" / f"{dname}.py",
                                  f"portbench.drivers.{dname}")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.layers = {slug: load_json(self.bench / "layers" /
                                       f"{slug}.json")
                       for slug in spec["layers"]}
        self.limits = self.config["limits"]

    def reader(self, metric):
        path = self.bench / "metrics" / f"{metric}.py"
        return load_module(path, f"portbench.metrics.{metric}").read


def card_line():
    """nvidia-smi's name and power limit of the first card."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        "nvidia-smi failed")


def run(cell, seed, seconds, trace, device="cuda", t0=None, log=sys.stderr):
    """One run; returns the result dict (the JSON line).  `t0`: the
    host clock at the process's start (set-up counts from there).
    `device` is "cuda", or "cpu" for the harness's own tests."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch
    import cuclarabel_torch  # noqa: F401
    print(f"portbench: imported at {time.perf_counter() - t0:.3f} s",
          file=log, flush=True)
    wrappers = None
    if trace:
        from . import tracing
        # installed before set-up: the program looks some entries up
        # when it is built
        wrappers = tracing.Wrappers(cell.layers)
        wrappers.install()
    try:
        return _run(cell, seed, seconds, trace, device, t0, log, torch,
                    wrappers)
    finally:
        if wrappers is not None:
            wrappers.remove()


def _sync(torch, device):
    if device != "cpu":
        torch.cuda.synchronize()


def _run(cell, seed, seconds, trace, device, t0, log, torch, wrappers):
    drv = cell.driver.Driver(cell, seed, device)
    _sync(torch, device)
    setup_s = time.perf_counter() - t0
    print(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s",
          file=log, flush=True)

    results, times = [], []
    record = None
    if trace:
        record, results = _traced_window(cell, drv, torch, device, wrappers,
                                         log)
    else:
        # the answers are kept for the check: frozen after each group, so
        # that the collector does not walk them again and again
        gc.freeze()
        start = time.perf_counter()
        k = 0
        while True:
            data = drv.data(k)
            tb = time.perf_counter()
            answers = drv.serve(data)
            te = time.perf_counter()
            times.append(te - tb)
            results.append((data, answers))
            gc.freeze()
            k += 1
            if te - start >= seconds:
                break
        window_s = te - start
        gc.unfreeze()
    chips = int(cell.entry["chips"])
    peak = (max(torch.cuda.max_memory_allocated(i) for i in range(chips))
            if device != "cpu" else 0)
    struct = drv.struct
    drv.close()
    del drv
    if device != "cpu":
        torch.cuda.empty_cache()

    if not trace:
        print(f"portbench: {len(times)} groups in {window_s:.3f} s, "
              f"{window_s - sum(times):.3f} s outside them; group ms "
              f"{[round(x * 1e3, 1) for x in times]}", file=log, flush=True)
    tc = time.perf_counter()
    checks, attempted, solved = check(cell, struct, results, seed)
    print(f"portbench: answers checked in {time.perf_counter() - tc:.3f} s",
          file=log, flush=True)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"problems_per_s": solved / window_s,
                  "batch_ms_p90": yardstick.p90(times) * 1e3,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name() if device != "cpu"
                    else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted,
           "failed": attempted - solved, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = record["busy_s"]
        dev["window_s"] = record["window_s"]
        out["breakdown"] = record["breakdown"]
    out["checks"] = checks
    return out


def _traced_window(cell, drv, torch, device, wrappers, log):
    """One group; `profiled_batches` groups timed on the host clock with
    no profiler running (the wrappers only add up each layer's host
    time), which give the host time that the profiler does not inflate;
    then as many groups under torch.profiler, each in a batch range.
    The trace is reduced in memory and deleted.  A trace that dropped
    events is taken again, up to three times, before the run fails."""
    import tempfile

    from cuclarabel_torch.kkt import ldl

    from . import tracing
    nprof = int(cell.traffic["profiled_batches"])
    k = 0
    results = []

    def one():
        nonlocal k
        data = drv.data(k)
        k += 1
        tb = time.perf_counter()
        if wrappers.ranges:
            with torch.profiler.record_function(tracing.BATCH):
                answers = drv.serve(data)
        else:
            answers = drv.serve(data)
        _sync(torch, device)
        results.append((data, answers))
        return time.perf_counter() - tb

    one()
    wrappers.reset()
    plain = {"batches": nprof, "batch_s": [one() for _ in range(nprof)]}
    plain["counts"] = dict(wrappers.counts)
    plain["host_s"] = dict(wrappers.host_s)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    err = None
    for _ in range(3):
        wrappers.reset()
        wrappers.ranges = True
        before = sum(ldl.LAUNCHES.values())
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(nprof):
                one()
        wrappers.ranges = False
        launched = sum(ldl.LAUNCHES.values()) - before
        tr = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            print(f"portbench: trace of {os.path.getsize(path)} bytes",
                  file=log, flush=True)
            trace = load_json(path)
        try:
            record = tracing.reduce_trace(trace, cell.layers)
        except tracing.TraceError as exc:
            err = exc
            print(f"portbench: {exc}; tracing again", file=log, flush=True)
            continue
        finally:
            del trace
        print(f"portbench: trace read in {time.perf_counter() - tr:.3f} s",
              file=log, flush=True)
        record["counts"] = dict(wrappers.counts)
        record["plain"] = plain
        print(f"portbench: profiled batches {record['batch_host_s']} s, "
              f"unprofiled {plain['batch_s']} s", file=log, flush=True)
        ldl_kernels = sum(info["kernels"] for slug, info in
                          record["layers"].items()
                          if cell.layers[slug].get("counter") == "ldl")
        if device != "cpu" and ldl_kernels != launched:
            raise tracing.TraceError(
                f"{ldl_kernels} kernels were launched inside the LDL^T "
                f"ranges, but ldl.LAUNCHES counted {launched}")
        return record, results
    raise err


def _sample(seed, results, nrand, nhard):
    """(batch, index) pairs of the answers the reference solves again:
    `nrand` drawn from the seed, then the `nhard` others with the most
    iterations."""
    sizes = [len(sols) for _, sols in results]
    total = sum(sizes)
    rng = generators.rng(seed, generators.SAMPLE, 0)
    flat = rng.choice(total, size=min(nrand, total), replace=False)
    offs = np.cumsum([0] + sizes)
    picks = [(int(np.searchsorted(offs, f, side="right") - 1),
              int(f - offs[np.searchsorted(offs, f, side="right") - 1]))
             for f in flat]
    its = [(s.iterations, bi, i) for bi, (_, sols) in enumerate(results)
           for i, s in enumerate(sols)]
    its.sort(key=lambda t: (-t[0], t[1], t[2]))
    chosen = set(picks)
    want = len(picks) + nhard
    for _, bi, i in its:
        if len(chosen) >= want:
            break
        if (bi, i) not in chosen:
            chosen.add((bi, i))
            picks.append((bi, i))
    return picks


def check(cell, struct, results, seed):
    """The comparison that decides `correct`.  Every answer that says
    SOLVED is held to its certificate; a sample is solved again by the
    plain reference, whose status it must share.  `results`: (data,
    answers) per batch, each answer with x, s, z, status.name and
    iterations.  Returns ({name: {"value", "limit"}}, attempted,
    solved)."""
    lim = cell.limits
    worst = {"res_primal": 0.0, "res_dual": 0.0, "gap": 0.0}
    attempted = solved = missing = 0
    for data, sols in results:
        size = len(data["q"])
        attempted += size
        missing += abs(size - len(sols))
        sols = sols[:size]
        ok = [s for s in sols if s.status.name == "SOLVED"]
        solved += len(ok)
        if not ok:
            continue
        idx = [i for i, s in enumerate(sols) if s.status.name == "SOLVED"]
        x = np.stack([s.x for s in ok])
        s_ = np.stack([s.s for s in ok])
        z = np.stack([s.z for s in ok])
        got = cell.reference.measures(struct["P"], struct["A"],
                                      struct["cones"], data["q"][idx],
                                      data["b"][idx], x, s_, z)
        for key, v in zip(("res_primal", "res_dual", "gap"), got):
            worst[key] = max(worst[key], float(v.max()))
    mismatch = missing
    for bi, i in _sample(seed, results, SAMPLE_RANDOM, SAMPLE_HARDEST):
        data, sols = results[bi]
        ref = cell.reference.solve(
            struct["P"], data["q"][i], struct["A"], data["b"][i],
            struct["cones"], solved_tol=min(lim["res_primal"],
                                            lim["res_dual"], lim["gap"]))
        if i >= len(sols):
            continue
        mismatch += int(ref["solved"] != (sols[i].status.name == "SOLVED"))
    checks = {"res_primal": {"value": worst["res_primal"],
                             "limit": lim["res_primal"]},
              "res_dual": {"value": worst["res_dual"],
                           "limit": lim["res_dual"]},
              "gap": {"value": worst["gap"], "limit": lim["gap"]},
              "status_mismatch": {"value": mismatch, "limit": 0}}
    return checks, attempted, solved


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
