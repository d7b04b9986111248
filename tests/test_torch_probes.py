"""The port's issue-rate probes on the CPU (cuclarabel_torch/probes: the
plain PyTorch versions that stand beside the Hopper kernels of
csrc/probes.cu) against the JAX package's TPU probes,
scripts/mosaic_probe.py (P1) and scripts/mosaic_probe2.py (P2), run in
Pallas interpret mode without editing them.

Inputs come from numpy with a seed (x in (-1, 1), y in (-0.9, 0.9)) and
the same arrays go to both packages.  Bar: 1e-6 relative to
max(|ref|, 1).  XLA:CPU contracts the reference's r * y + y into one FMA,
while the port rounds the multiply and the add apart (as its kernels do,
built with -fmad=false), so the two differ by rounding alone: about
3.4e-7 after 48 rounds, and the chain's |y| < 0.9 damps what came
before."""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from cuclarabel_torch.kkt import _build, ldl
from cuclarabel_torch.probes import mosaic_probe as p1
from cuclarabel_torch.probes import mosaic_probe2 as p2

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
N, B = 13, 256
P1_CASES = [("A", None), ("B", None), ("C", None), ("D", 8), ("D", 16),
            ("D", 32)]
P2_CASES = [(8, 1), (32, 1), (8, 4), (32, 4)]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def _interpret_call(*args, compiler_params=None, **kwargs):
    """pl.pallas_call in interpret mode, without the TPU's compiler
    parameters."""
    return pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture(scope="module")
def ref_p1():
    """scripts/mosaic_probe.py loaded at (N, B): it reads sys.argv when
    imported."""
    path = ROOT / "scripts" / "mosaic_probe.py"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [str(path), str(N), str(B)])
        spec = importlib.util.spec_from_file_location("_ref_mosaic_probe",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    assert (mod.N, mod.B) == (N, B)
    return mod


@pytest.fixture(scope="module")
def ref_make():
    """scripts/mosaic_probe2.py's `make`, taken out with ast: the script
    runs its sweep when imported."""
    path = ROOT / "scripts" / "mosaic_probe2.py"
    tree = ast.parse(path.read_text())
    make = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "make")
    ns = {"pl": SimpleNamespace(BlockSpec=pl.BlockSpec,
                                pallas_call=_interpret_call),
          "jax": jax, "jnp": jnp, "_CP": None, "OPS": 512}
    exec(compile(ast.Module(body=[make], type_ignores=[]), str(path),
                 "exec"), ns)
    return ns["make"]


def _run_ref_p1(mod, kern, x, y):
    """bench's pallas_call (scripts/mosaic_probe.py:65-71) on x, y."""
    mat = pl.BlockSpec((mod.N, mod.N, mod.LANES), lambda i: (0, 0, i))
    f = _interpret_call(
        kern, grid=(mod.B // mod.LANES,), in_specs=[mat, mat],
        out_specs=mat,
        out_shape=jax.ShapeDtypeStruct((mod.N, mod.N, mod.B), jnp.float32))
    return np.asarray(f(jnp.asarray(x), jnp.asarray(y)))


def _ref_kernel(mod, variant, rows):
    return {"A": mod.kern_chain, "B": mod.kern_chain_win,
            "C": mod.kern_ilp}.get(variant) or mod.make_chunk(rows)


@pytest.mark.parametrize("variant,rows", P1_CASES,
                         ids=[p1.name(v, r) for v, r in P1_CASES])
def test_p1_matches_reference(ref_p1, variant, rows):
    x, y = p1.inputs((N, N, B), seed=11)
    got = p1.chain(x, y, variant, rows)
    ref = _run_ref_p1(ref_p1, _ref_kernel(ref_p1, variant, rows),
                      x.numpy(), y.numpy())
    assert got.dtype == torch.float32 and got.shape == (N, N, B)
    assert _rel(got.numpy(), ref) < TOL
    if variant == "B":  # outside the window o is x, exactly
        np.testing.assert_array_equal(got.numpy()[:3], x.numpy()[:3])
        np.testing.assert_array_equal(got.numpy()[:, :3], x.numpy()[:, :3])


@pytest.mark.parametrize("R,streams", P2_CASES,
                         ids=[p2.name(R, s) for R, s in P2_CASES])
def test_p2_matches_reference(ref_make, R, streams):
    x, y = p1.inputs((R, p2.LANES), seed=R + streams)
    got = p2.run(x, y, p2.OPS, streams)
    f, _ = ref_make(R, streams=streams)
    ref = np.asarray(f(jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    assert got.dtype == torch.float32 and got.shape == (R, p2.LANES)
    assert _rel(got.numpy(), ref) < TOL


def test_operation_counts_match_reference(ref_p1, ref_make):
    """P2's real_ops is the reference's (511 at one stream and at four);
    P1 does OPS = 96 per element in A, B's window and D, and 95 in C
    (4 scalings, 4 x 11 rounds, 3 sums), where the reference prints 96."""
    for streams in (1, 4):
        assert p2.real_ops(p2.OPS, streams) == ref_make(8, streams=streams)[1]
        assert p2.real_ops(p2.OPS, streams) == 511
    E = N * N * B
    assert p1.OPS == ref_p1.OPS and p1.ROUNDS == ref_p1.OPS // 2
    assert p1.ILP_ROUNDS == (ref_p1.OPS - 4 - 3) // 8
    assert p1.work("A", N, B) == (12 * E, 96 * E) == p1.work("D", N, B)
    assert p1.work("C", N, B) == (12 * E, 95 * E)
    W = (N - 3) ** 2 * B
    assert p1.work("B", N, B) == (4 * (2 * E + W), 96 * W)
    assert p1.work("A", 83, 4096)[0] == 338_608_128  # 338.6 MB


def test_chunked_variants_equal_the_chain():
    x, y = p1.inputs((7, 7, 130), seed=3)
    a = p1.chain(x, y, "A")
    for rows in p1.CHUNK_ROWS:
        assert torch.equal(p1.chain(x, y, "D", rows), a)


def test_plain_calls_counted_and_kernels_not():
    ldl.reset_counts()
    x, y = p1.inputs((4, 4, 3), seed=0)
    p1.chain(x, y, "C")
    xi, yi = p1.inputs((8, p2.LANES))
    p2.run(xi, yi, p2.OPS, 4)
    assert dict(ldl.PLAIN_CALLS) == {"probe_chain/C": 1,
                                     "probe_issue/R8s4": 1}
    assert not ldl.LAUNCHES


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, y = p1.inputs((5, 5, 4), seed=0)
    with pytest.raises(TypeError):
        p1.chain(x.double(), y.double(), "A")
    with pytest.raises(ValueError):
        p1.chain(x, y[:, :, :2].contiguous(), "A")  # shapes differ
    with pytest.raises(ValueError):
        p1.chain(x[:, :4], y[:, :4], "A")  # not (N, N, B)
    with pytest.raises(ValueError):
        p1.chain(x.transpose(0, 1), y, "A")  # not contiguous
    for variant, rows in (("E", None), ("D", None), ("D", 12), ("A", 8)):
        with pytest.raises(ValueError):
            p1.chain(x, y, variant, rows)
    meta = torch.empty(x.shape, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        p1.chain(x, meta, "A")
    xi, yi = p1.inputs((16, p2.LANES))
    with pytest.raises(ValueError):
        p2.run(xi, yi, p2.OPS, 1)  # R = 16 is no instantiation
    xi, yi = p1.inputs((128, p2.LANES))
    with pytest.raises(ValueError):
        p2.run(xi, yi, p2.OPS, 4)  # (128, 4) neither
    with pytest.raises(ValueError):
        p2.run(xi[:, :64].contiguous(), yi[:, :64].contiguous(), p2.OPS, 1)


def test_entry_points_run_on_cuda_or_cpu(capsys):
    """Like every entry point of the port, the probes run on CUDA unless
    given device="cpu", and raise without a card; on the CPU they print
    their lines with no device time."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p1.main(["5", "128"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p2.main()
    rows = p1.sweep(5, 128, device="cpu")
    assert [r["name"] for r in rows] == ["A", "B", "C", "D8", "D16", "D32"]
    assert all(r["ms"] is None and r["bound_by"] == "bytes" for r in rows)
    rows = p2.sweep(device="cpu")
    assert [(r["R"], r["streams"]) for r in rows] == list(p2.SWEEP)
    assert rows[0]["sm_bound_ms"] == pytest.approx(2.065e-3, rel=1e-3)
    assert rows[5]["sm_bound_ms"] == pytest.approx(0.5285, rel=1e-3)
    out = capsys.readouterr().out
    assert out.count("not measured") == 6 + len(p2.SWEEP)


def test_importing_the_probes_runs_nothing():
    """The reference reads sys.argv and runs its sweep when imported; the
    port's modules do neither."""
    code = ("import sys; sys.argv = ['x', 'not-a-number']; "
            "import cuclarabel_torch.probes.mosaic_probe, "
            "cuclarabel_torch.probes.mosaic_probe2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == ""


def test_ptxas_report_names_each_instantiation():
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118probe_issue_kernelILi128ELi1EEEvPKfS2_Pfi' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_118probe_issue_kernelILi128ELi1EEEvPKfS2_Pfi\n"
        "    1040 bytes stack frame, 1036 bytes spill stores, "
        "1040 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 0 barriers, 380 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118probe_chain_kernelILi0ELi8EEEvPKfS2_Pfjji' "
        "for 'sm_90a'\n"
        "ptxas info    : Used 30 registers, used 0 barriers\n")
    rep = _build.ptxas_report(log)
    assert len(rep) == 2
    issue = p1.ptxas_by_template(log, "probe_issue_kernel")
    assert issue == {(128, 1): {
        "registers": 255, "stack_frame": 1040, "spill_stores": 1036,
        "spill_loads": 1040}}
    assert "255 registers" in p1.ptxas_text(issue[(128, 1)])
    assert p1.ptxas_by_template(log, "probe_chain_kernel") == {
        (0, 8): {"registers": 30}}
    assert p1.ptxas_by_template("", "probe_issue_kernel") == {}


def test_a_found_build_returns_its_log(tmp_path, monkeypatch):
    """The probes' entry points read ptxas' report from build()'s log, so
    a build that is found (made by an earlier process) returns the log
    its compile wrote.  nvcc is a stub here that writes its -o file."""
    def fake_run(cmd):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return f"ptxas info    : Used 7 registers ({Path(cmd[-1]).name})\n"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run", fake_run)
    made = _build.build()
    assert made["log"].count("Used 7 registers") == len(_build.SOURCES) + 1
    found = _build.build()
    assert found["seconds"] == 0.0 and found["path"] == made["path"]
    assert found["log"] == made["log"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [made["path"].name, made["path"].with_suffix(".log").name])
