"""Whole runs on the CPU at tiny sizes (the chip check skipped): the
runner finds a new cell, configuration and metric from files alone, a
sound run is correct, the float32 control is not, and neither is a run
with the timed path broken underneath."""

import json

import numpy as np
import pytest
import torch

from portbench import control, harness


def _run(tree, cell, trace=False, seconds=0.5, seed=2 ** 31 + 3):
    return harness.run(harness.Cell(tree, cell), seed, seconds, trace,
                       device="cpu")


@pytest.mark.parametrize("cell", ["tiny-portfolio", "tiny-maxcut"])
def test_a_sound_run_is_correct(tiny_tree, cell):
    out = _run(tiny_tree, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 16
    assert set(out["metrics"]) == {"problems_per_s", "batch_ms_p90",
                                   "setup_s"}
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_runner_finds_a_new_metric_from_files(tiny_tree):
    bench = tiny_tree / "portbench"
    (bench / "metrics" / "loop_calls_per_batch.py").write_text(
        "def read(rec):\n"
        "    n = rec['counts'].get('pb:ipm_loop:run_passes#arg1')\n"
        "    return n / rec['batches'] if n else None\n")
    manifest = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({
        "name": "loop_calls_per_batch", "unit": "passes", "better": "lower",
        "source": "program_counter", "layer": "IPM loop",
        "moves": "problems_per_s", "workloads": ["tiny-maxcut"]})
    (tiny_tree / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = _run(tiny_tree, "tiny-maxcut", trace=True)
    assert out["correct"]
    got = out["metrics"]
    assert got["loop_calls_per_batch"]["value"] == pytest.approx(
        got["passes_per_batch"]["value"])
    assert got["frontend_ms_per_batch"]["value"] > 0
    # a CPU run launches no kernel: the device metrics read nothing
    assert "ldl_roofline" not in got and "device_idle_share" not in got
    # one group, two timed without the profiler, two profiled
    assert out["attempted"] == 5 * 16


def test_runner_finds_a_new_traffic_driver_and_layer_from_files(tiny_tree):
    bench = tiny_tree / "portbench"
    (bench / "drivers" / "closed_batch_copy.py").write_text(
        (bench / "drivers" / "closed_batch.py").read_text())
    (bench / "traffic" / "tiny-b8.json").write_text(json.dumps(
        {"driver": "closed_batch_copy", "batch": 8, "settings": {},
         "profiled_batches": 1}))
    (bench / "layers" / "psd.json").write_text(json.dumps(
        {"name": "PSD ops", "entries": [
            {"module": "cuclarabel_torch.cones.psd", "attr": "svec_to_mat"}]}))
    (bench / "workloads" / "tiny-maxcut-b8.json").write_text(json.dumps(
        {"layers": ["ipm_loop", "psd"]}))
    manifest = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tiny-maxcut-b8",
                                  "config": "tiny-maxcut",
                                  "traffic": "tiny-b8", "chips": 1,
                                  "why": "a test"})
    (tiny_tree / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.Cell(tiny_tree, "tiny-maxcut-b8")
    assert cell.driver.__name__.endswith("closed_batch_copy")
    assert set(cell.layers) == {"ipm_loop", "psd"}
    # a layer file that a cell does not name leaves it as it was
    assert "psd" not in harness.Cell(tiny_tree, "tiny-maxcut").layers
    out = _run(tiny_tree, "tiny-maxcut-b8")
    assert out["correct"] and out["attempted"] % 8 == 0


def test_the_float32_control_is_not_correct(tiny_tree):
    for cell in ("tiny-portfolio", "tiny-maxcut"):
        c = harness.Cell(tiny_tree, cell)
        for seed in (1, 2, 3):
            results, struct = control.control_results(c, seed, 2)
            checks, attempted, _ = harness.check(c, struct, results, seed)
            assert attempted == 24
            assert any(v["value"] > v["limit"] for v in checks.values())
            assert min(checks[k]["value"] for k in ("res_primal", "res_dual",
                                                    "gap")) >= 0
            results, struct = control.control_results(c, seed, 2,
                                                      dtype=np.float64)
            checks, _, _ = harness.check(c, struct, results, seed)
            assert all(v["value"] <= v["limit"] for v in checks.values())


def _broken_solve(monkeypatch, alter):
    """BatchSolver.solve with `alter` applied to the answers it returns."""
    import cuclarabel_torch as ct
    solve = ct.BatchSolver.solve

    def broken(self, *a, **k):
        return alter(solve(self, *a, **k))
    monkeypatch.setattr(ct.BatchSolver, "solve", broken)


def _altered(sols):
    sols[len(sols) // 3].x[0] += 1e-6
    return sols


def _half(sols):
    h = len(sols) // 2
    return sols[:h] + sols[:len(sols) - h]


def _unchanged(monkeypatch):
    from cuclarabel_torch.cones import ops
    step = ops.step_length
    monkeypatch.setattr(ops, "step_length",
                        lambda *a, **k: torch.zeros_like(step(*a, **k)))


@pytest.mark.parametrize("cell", ["tiny-portfolio", "tiny-maxcut"])
@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch",
                                   "step_returns_state_unchanged"])
def test_a_broken_timed_path_is_not_correct(tiny_tree, cell, fault,
                                            monkeypatch):
    if fault == "answer_altered":
        _broken_solve(monkeypatch, _altered)
    elif fault == "half_the_batch":
        _broken_solve(monkeypatch, _half)
    else:
        _unchanged(monkeypatch)
    out = _run(tiny_tree, cell, seconds=0.0)
    assert not out["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["portfolio-n148-pallas-b4096",
                                  "maxcut-n90-b4096"])
def test_a_short_run_on_the_card(cuda_card, cell):
    from conftest import ROOT
    out = harness.run(harness.Cell(ROOT, cell), 11, 1.0, False)
    assert out["correct"] and out["device"]["platform"] == "gpu"
