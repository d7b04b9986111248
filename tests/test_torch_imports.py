"""cuclarabel_torch stands alone: it and chip_smoke.py import neither
jax nor anything of cuclarabel_tpu, and without a CUDA device nothing
runs on the CPU unless the caller asks for it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cuclarabel_torch as ct
from cuclarabel_torch.problems import portfolio_socp

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import cuclarabel_torch
for m in pkgutil.walk_packages(cuclarabel_torch.__path__, "cuclarabel_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cuclarabel_tpu"))
print("LOADED", bad)
print("PORT", sorted(m for m in sys.modules if m.startswith("cuclarabel_torch")))
"""

# modules added with the single-problem Solver, the f32 LDL^T kernels,
# the issue-rate probes, the solve digests, the nonsymmetric cones, the
# PSD cones with the chordal decomposition, the sparse paths, and the
# multi-device paths, the modeling layer and precompile
NEW_MODULES = ("cuclarabel_torch.device", "cuclarabel_torch.equilibration",
               "cuclarabel_torch.info_print", "cuclarabel_torch.json_io",
               "cuclarabel_torch.kkt.ldl_f32", "cuclarabel_torch.presolve",
               "cuclarabel_torch.solver", "cuclarabel_torch.warmstart",
               "cuclarabel_torch.probes.mosaic_probe",
               "cuclarabel_torch.probes.mosaic_probe2",
               "cuclarabel_torch.solve_digest",
               "cuclarabel_torch.cones.nonsymmetric",
               "cuclarabel_torch.cones.exp", "cuclarabel_torch.cones.pow",
               "cuclarabel_torch.cones.genpow", "cuclarabel_torch.cones.psd",
               "cuclarabel_torch.chordal", "cuclarabel_torch.chordal.decomp",
               "cuclarabel_torch.chordal.graph",
               "cuclarabel_torch.chordal.merge",
               "cuclarabel_torch.chordal.sntree",
               "cuclarabel_torch.native", "cuclarabel_torch.qps",
               "cuclarabel_torch.sparse_solver",
               "cuclarabel_torch.parallel.sparse_batch",
               "cuclarabel_torch.kkt.scatter",
               "cuclarabel_torch.kkt.sparse_cpu",
               "cuclarabel_torch.kkt.sparse_device",
               "cuclarabel_torch.kkt.sparse_symbolic",
               "cuclarabel_torch.kkt.sparse_tpu",
               "cuclarabel_torch.modeling", "cuclarabel_torch.precompile",
               "cuclarabel_torch.parallel.sharded",
               "cuclarabel_torch.parallel.slabs",
               "cuclarabel_torch.kkt.arrow")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    for mod in NEW_MODULES:
        assert repr(mod) in out.stdout, mod


@pytest.mark.parametrize("module", [
    "cuclarabel_torch.sparse_solver", "cuclarabel_torch.parallel.sparse_batch",
    "cuclarabel_torch.qps", "cuclarabel_torch.native"])
def test_sparse_modules_import_no_jax(module):
    """Each sparse-path module alone pulls in neither jax nor the JAX
    package, and the native library builds without them."""
    code = (f"import sys, {module}\n"
            "import cuclarabel_torch.native as nat; nat.build()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cuclarabel_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("module", [
    "cuclarabel_torch.modeling", "cuclarabel_torch.precompile",
    "cuclarabel_torch.parallel.sharded", "cuclarabel_torch.kkt.arrow"])
def test_last_modules_import_no_jax(module):
    """The modeling layer, precompile and the sharded path, each alone,
    pull in neither jax nor the JAX package, and the package exports
    their public names as the reference's does."""
    code = (f"import sys, {module}\n"
            "from cuclarabel_torch import (Model, Variable, vstack, "
            "sum_entries, norm2, quad_form, sumsq, precompile, "
            "ShardedSolver)\n"
            "from cuclarabel_torch.parallel import ShardedSolver as S2\n"
            "assert S2 is ShardedSolver\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cuclarabel_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sparse_entry_points_default_to_cuda():
    """SparseSolver and BatchSparseSolver, like Solver, run on CUDA
    unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cuclarabel_torch.problems import grid_qp

    P, q, A, b, cones = grid_qp(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct.SparseSolver(P, q, A, b, cones)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct.BatchSparseSolver(P, q[None], A, b[None], cones)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct.Solver(P.toarray(), q, A.toarray(), b, cones,
                  direct_solve_method="qdldl")
    assert ct.SparseSolver(P, q, A, b, cones, device="cpu").solve().status \
        == ct.SolverStatus.SOLVED


def test_no_cuda_means_no_quiet_cpu_run():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A, q, b, cones = portfolio_socp(nass=4, batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct.BatchSolver(None, q, A, b, cones)
    sols = ct.BatchSolver(None, q, A, b, cones, device="cpu").solve()
    assert all(s.status == ct.SolverStatus.SOLVED for s in sols)


def test_solver_needs_cuda_or_cpu():
    """Solver, like BatchSolver, runs on CUDA unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = (np.eye(1), np.zeros(1), np.eye(1), np.ones(1),
            [ct.NonnegativeConeT(1)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct.Solver(*data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ct.Solver(*data, device="cuda")
    assert ct.Solver(*data, device="cpu").solve().status == \
        ct.SolverStatus.SOLVED


@pytest.mark.parametrize("entry", ["make_dense_kkt", "make_solve_fn",
                                   "make_batch_solve_fn"])
def test_factories_default_to_cuda(entry):
    """The solve-function factories, like BatchSolver, run on CUDA
    unless given device="cpu": without a card they raise."""
    from cuclarabel_torch.cones.layout import build_layout
    from cuclarabel_torch.ipm.loop import make_solve_fn
    from cuclarabel_torch.kkt.dense import make_dense_kkt
    from cuclarabel_torch.parallel.batch import make_batch_solve_fn

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, q, b, cones = portfolio_socp(nass=4, batch=1)
    layout = build_layout(tuple(cones))
    n, m = q.shape[1], b.shape[1]
    settings = ct.Settings()
    make = {
        "make_dense_kkt": lambda **kw: make_dense_kkt(n, m, settings, layout,
                                                      **kw),
        "make_solve_fn": lambda **kw: make_solve_fn(layout, settings, n, m,
                                                    False, **kw),
        "make_batch_solve_fn": lambda **kw: make_batch_solve_fn(
            layout, settings, n, m, False, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    made = make(device="cpu")
    assert callable(made[1] if isinstance(made, tuple) else made)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result when there is no
    CUDA device, and when it stands in a directory without the package."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd, env = tmp_path, dict(os.environ, PYTHONPATH="")
    else:
        cwd, env = ROOT, _env()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_wrappers_reject_mixed_devices():
    from cuclarabel_torch.kkt import ldl

    K = torch.eye(3, dtype=torch.float64)[None]
    meta = torch.empty((1, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        ldl.ldl_factor(K, meta)
    np.testing.assert_array_equal(
        ldl.ldl_factor(K, torch.zeros(1, 3, dtype=torch.float64))[1].numpy(),
        np.ones((1, 3)))
