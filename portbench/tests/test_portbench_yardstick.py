"""The frozen yardstick and the trace reduction on synthetic traces: the
percentile over all batches, the idle share, the roofline share, the
layer attribution and the dropped-event guard."""

import numpy as np
import pytest

from conftest import make_tree
from portbench import harness, tracing, yardstick

LAYERS = {"ldl": {"name": "LDLT kernels", "entries": [
    {"module": "m", "attr": "ldl_factor", "args": True}]},
    "ipm_loop": {"name": "IPM loop", "entries": [
        {"module": "m", "attr": "run_passes"}]}}


def test_p90_is_over_all_batches():
    values = list(range(1, 101))
    assert yardstick.p90(values) == pytest.approx(np.percentile(values, 90))
    assert yardstick.p90([5.0] * 9 + [100.0]) == pytest.approx(14.5)


def test_union_and_clip():
    assert yardstick.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert yardstick.clip_spans([(0, 10)], [(2, 3), (5, 7)]) == [(2, 3),
                                                                (5, 7)]


def test_work_and_bound_match_the_data_sheet():
    nbytes, ops = yardstick.work("ldl_factor", 4096, 148)
    t = yardstick.bound_seconds(nbytes, ops)
    assert t == pytest.approx(max(nbytes / 3.35e12, ops / 67e12))
    with pytest.raises(ValueError):
        yardstick.work("nothing", 1, 1)


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic(drop=False):
    """Two batches of 1000 us.  Batch 1: run_passes 100-900 holds an
    ldl_factor call (200-300) launching one kernel of 50 us at 400 and
    a launch outside it (kernel of 100 us); batch 2: one kernel of
    200 us."""
    ev = [_ev(tracing.BATCH, "user_annotation", 0, 1000),
          _ev(tracing.BATCH, "user_annotation", 2000, 1000),
          _ev("pb:ipm_loop:run_passes", "user_annotation", 100, 800),
          _ev("pb:ldl:ldl_factor|T8x148x148,T8x148", "user_annotation",
              200, 100),
          _ev("cudaLaunchKernel", "cuda_runtime", 250, 5, corr=1),
          _ev("ldl_factor_wide_kernel", "kernel", 400, 50, tid=7, corr=1),
          _ev("cudaLaunchKernel", "cuda_runtime", 500, 5, corr=2),
          _ev("elementwise", "kernel", 600, 100, tid=7, corr=2),
          _ev("cudaLaunchKernel", "cuda_runtime", 2100, 5, corr=3),
          _ev("reduce", "kernel", 2200, 200, tid=7, corr=3)]
    if drop:
        ev = [e for e in ev if e.get("args", {}).get("correlation") != 3
              or e["cat"] != "kernel"]
    return {"traceEvents": ev}


def test_reduce_trace_attributes_kernels_to_layers():
    rec = tracing.reduce_trace(synthetic(), LAYERS)
    assert rec["batches"] == 2 and rec["kernels"] == 3
    assert rec["window_s"] == pytest.approx(2000e-6)
    assert rec["busy_s"] == pytest.approx(350e-6)
    assert rec["layers"]["ldl"]["kernels"] == 1
    assert rec["layers"]["ldl"]["device_s"] == pytest.approx(50e-6)
    assert rec["layers"]["ipm_loop"]["kernels"] == 2
    assert rec["layers"]["ipm_loop"]["host_s"] == pytest.approx(800e-6)
    call, = rec["layers"]["ldl"]["calls"]
    assert call["entry"] == "ldl_factor" and call["kernels"] == 1
    assert call["args"] == [(8, 148, 148), (8, 148)]
    names = [n for n, _ in rec["breakdown"]["device_ops"]]
    assert names[0] == "reduce"


def test_metric_readers_on_a_synthetic_trace(tmp_path):
    tree = make_tree(tmp_path / "tree")
    cell = harness.Cell(tree, "tiny-portfolio")
    rec = tracing.reduce_trace(synthetic(), LAYERS)
    rec["counts"] = {"pb:ipm_loop:run_passes#arg1": 10}
    # two batches timed without the profiler: 1400 us in all, 700 of it
    # in run_passes, over 8 passes
    rec["plain"] = {"batches": 2, "batch_s": [600e-6, 800e-6],
                    "counts": {"pb:ipm_loop:run_passes#arg1": 8},
                    "host_s": {"pb:ipm_loop:run_passes": 700e-6}}
    idle = cell.reader("device_idle_share")(rec)
    assert idle == pytest.approx(100 * (1 - (350 / 10) / (1400 / 8)))
    share = cell.reader("ldl_roofline")(rec)
    bound = yardstick.bound_seconds(*yardstick.work("ldl_factor", 8, 148))
    assert share == pytest.approx(100 * bound / 50e-6)
    assert cell.reader("launches_per_pass")(rec) == pytest.approx(0.3)
    assert cell.reader("passes_per_batch")(rec) == pytest.approx(5)
    assert cell.reader("frontend_ms_per_batch")(rec) == pytest.approx(0.35)
    del rec["plain"]
    assert cell.reader("device_idle_share")(rec) is None
    assert cell.reader("frontend_ms_per_batch")(rec) is None
    rec["layers"]["ldl"]["calls"] = []
    assert cell.reader("ldl_roofline")(rec) is None


def test_a_dropped_event_fails_the_trace():
    with pytest.raises(tracing.TraceError):
        tracing.reduce_trace(synthetic(drop=True), LAYERS)
