"""Nothing under portbench/ imports jax, jaxlib, flax or cuclarabel_tpu
(top-level module names compared whole), the reference imports nothing
of cuclarabel_torch, and a run without a card exits non-zero with no
result."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "cuclarabel_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in (ROOT / "portbench").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for p in files:
        bad = set(_imports(p)) & FORBIDDEN
        assert not bad, (p, bad)


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "cuclarabel_torch" not in set(_imports(p)), p
    for p in (ROOT / "portbench" / "generators").rglob("*.py"):
        assert "cuclarabel_torch" not in set(_imports(p)), p


def test_layer_files_name_only_the_port():
    import json
    for p in (ROOT / "portbench" / "layers").glob("*.json"):
        for e in json.loads(p.read_text())["entries"]:
            assert e["module"].split(".")[0] == "cuclarabel_torch"


def test_a_run_without_a_card_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "maxcut-n90-b4096", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
