"""Tests of the benchmark harness, on the CPU at tiny sizes; a test that
needs the card is marked `cuda` and skips without one.  Run them with

    python3 -m pytest portbench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"tiny-portfolio": ("portfolio-socp-n148", {"nass": 8}),
        "tiny-maxcut": ("maxcut-sdp-n90", {"nv": 4})}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def make_tree(dest, batch=16):
    """A copy of the benchmark at `dest` with a tiny portfolio and max-cut
    configuration and one cell each ("tiny-portfolio" under "pallas",
    "tiny-maxcut" under the defaults), each with a traffic file of its
    own, found from files alone."""
    dest = Path(dest)
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (base, change) in TINY.items():
        cfg = json.loads((ROOT / "portbench" / "configs" /
                          f"{base}.json").read_text())
        cfg.update(change, name=cell)
        (dest / "portbench" / "configs" / f"{cell}.json").write_text(
            json.dumps(cfg))
        manifest["configs"].append({
            "name": cell, "source": "a test", "reduced": sorted(change),
            "file": f"portbench/configs/{cell}.json", "why": "a test"})
        traffic = f"tiny-{cell}"
        settings = ({"kkt_solve_method": "pallas"} if "portfolio" in cell
                    else {})
        (dest / "portbench" / "traffic" / f"{traffic}.json").write_text(
            json.dumps({"driver": "closed_batch", "batch": batch,
                        "settings": settings, "profiled_batches": 2}))
        (dest / "portbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps({"layers": ["ipm_loop", "cones", "kkt", "ldl"]}))
        manifest["workloads"].append({"name": cell, "config": cell,
                                      "traffic": traffic, "chips": 1,
                                      "why": "a test"})
        for m in manifest["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


@pytest.fixture
def tiny_tree(tmp_path):
    return make_tree(tmp_path / "tree")
