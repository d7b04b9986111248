"""cuclarabel_torch.kernel_timing off the card: the work and bound it
charges each kernel, and its kernel calls, which on CPU tensors run the
plain versions."""

import pytest
import torch

from cuclarabel_torch import kernel_timing as kt
from cuclarabel_torch.kkt import ldl


def test_work_counts_the_triangles_the_function_needs():
    N, B = 76, 4096
    tri, stri = N * (N + 1) // 2, N * (N - 1) // 2
    assert kt.work("ldl_solve", B, N)[0] == B * 8 * (stri + 3 * N)
    assert kt.work("kkt_residual", B, N, R=2)[0] == B * 8 * (tri + 6 * N)
    nbytes, ops = kt.work("ldl_solve_refine", B, N)
    assert nbytes == B * 8 * (tri + stri + 4 * N)
    ms, by = kt.bound_ms(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)


def test_row_line_shows_the_optional_times_only_where_measured():
    row = {"name": "ldl_solve", "R": 1, "N": 76, "B": 256, "ms": 0.01,
           "plain_ms": 10.0, "bound_ms": 0.002, "bound_by": "bytes",
           "gb": 0.006, "gflop": 0.003, "blocks_per_sm": 9,
           "warps_per_sm": 36}
    line = kt.row_line("card", row)
    assert "device 0.0100 ms" in line and "9 blocks / 36 warps" in line
    assert "flushed" not in line and "events" not in line
    line = kt.row_line("card", dict(row, cold_ms=0.02, events_ms=0.03))
    assert "L2 flushed 0.0200 ms" in line and "by events 0.0300 ms" in line
    line = kt.row_line("card", dict(row, timed_by="profiler"))
    assert "(L2 warm)" in line and "events" not in line
    line = kt.row_line("card", dict(row, timed_by="events"))
    assert "(L2 warm, CUDA events)" in line


def test_session_durations_keep_the_last_launches_of_the_session():
    """A session's trace may lack launches or hold another session's: a
    kernel is timed by its last `reps` launches by start time, if at
    least half of them were recorded."""
    def ev(name, ts, dur):
        return {"name": f"void {name}(double*)", "ts": ts, "dur": dur}

    mine = [ev("ldl_solve_kernel<1, 3>", 100 + t, 2.0) for t in range(4)]
    stale = [ev("ldl_solve_kernel<1, 3>", t, 50.0) for t in range(3)]
    other = [ev("ldl_solve_refine_kernel<1, 3>", 200, 9.0)]
    events = other + mine[::-1] + stale
    assert kt.session_durations(events, "ldl_solve_kernel<1", 4) == [
        0.002] * 4
    assert kt.session_durations(mine[2:], "ldl_solve_kernel<1", 4) == [
        0.002] * 2
    assert kt.session_durations(mine[3:], "ldl_solve_kernel<1", 4) is None
    assert kt.session_durations(other, "ldl_solve_kernel<1", 4) is None


def test_calls_cover_every_form_and_agree_with_plain_on_cpu():
    op = kt.operands(3, dev="cpu")
    forms = kt.calls(op)
    assert set(forms) == set(kt.FORMS)
    ldl.reset_counts()
    for (name, R), (kern, plain) in forms.items():
        got, want = kern(), plain()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), (name, R)
    assert not ldl.LAUNCHES
    assert set(kt.KERNEL_NAMES) == {name for name, _ in kt.FORMS}


def test_rates_count_unfused_instructions():
    """The kernels build with -fmad=false, so the operations rate is one
    multiply or add per lane and clock: 16.7 T op/s in f64 and 33.5 in
    f32 at 1.98 GHz, half the data sheet's FMA-counted rates.  Every f64
    kernel form stays bound by bytes at the main path's widths, and so do
    the f32 kernels at (76, 4096)."""
    assert kt.PEAK_F64_PER_S == pytest.approx(16.7e12, rel=2e-3)
    assert kt.PEAK_F32_PER_S == pytest.approx(33.5e12, rel=2e-3)
    for B in kt.WIDTHS:
        for name, R in kt.F64_FORMS:
            assert kt.bound_ms(*kt.work(name, B, 76, R=R))[1] == "bytes"
    for name in ("ldl_factor_batched", "ldl_solve_batched"):
        assert kt.bound_ms(*kt.work(name, 4096, 76),
                           kt.PEAK_F32_PER_S)[1] == "bytes"


def test_ptxas_finds_the_instantiation_each_form_launches():
    """ptxas' numbers of the device function a form runs at N = 76
    (slots 3): matched by its template arguments (R, slots), or by as
    many as an older build's kernel has."""
    def rec(regs):
        return {"registers": regs, "spill_stores": 0, "spill_loads": 0}

    new = {
        "_ZN12_GLOBAL__N_117ldl_factor_kernelILi3EEEvPKdS2_PdS3_Phi":
            rec(80),
        "_ZN12_GLOBAL__N_117ldl_factor_kernelILi4EEEvPKdS2_PdS3_Phi":
            rec(90),
        "_ZN12_GLOBAL__N_119kkt_residual_kernelILi1ELi3EEEvPKdS2_S2_Pdi":
            rec(60),
        "_ZN12_GLOBAL__N_119kkt_residual_kernelILi2ELi3EEEvPKdS2_S2_Pdi":
            rec(70),
        "_ZN12_GLOBAL__N_121ldl_factor_f32_kernelILi3EEEvPKfPfS3_i":
            rec(50),
    }
    assert kt.ptxas("ldl_factor", 1, 76, new)["registers"] == 80
    assert kt.ptxas("ldl_factor", 1, 128, new)["registers"] == 90
    assert kt.ptxas("kkt_residual", 2, 76, new)["registers"] == 70
    assert kt.ptxas("ldl_factor_batched", 1, 76, new)["registers"] == 50
    assert kt.ptxas("ldl_solve", 1, 76, new) is None
    old = {
        "_ZN12_GLOBAL__N_117ldl_factor_kernelEPKdS1_PdS2_Phi": rec(40),
        "_ZN12_GLOBAL__N_119kkt_residual_kernelILi1EEEvPKdS1_S1_Pdi":
            rec(30),
    }
    assert kt.ptxas("ldl_factor", 1, 76, old)["registers"] == 40
    assert kt.ptxas("kkt_residual", 1, 76, old)["registers"] == 30
    assert kt.ptxas("kkt_residual", 2, 76, old) is None


def test_ptxas_and_names_of_the_wide_forms():
    """Above N = 128 the forms run the wide kernels (csrc/ldl_wide.cu),
    templates on the scalar type and R: kernel_name gives the profiler's
    prefix, and ptxas the instantiation of that type and R."""
    def rec(regs):
        return {"registers": regs, "spill_stores": 0, "spill_loads": 0}

    report = {
        "_ZN12_GLOBAL__N_122ldl_factor_wide_kernelIdEEvPKT_S3_PS1_S4_Phi":
            rec(40),
        "_ZN12_GLOBAL__N_122ldl_factor_wide_kernelIfEEvPKT_S3_PS1_S4_Phi":
            rec(38),
        "_ZN12_GLOBAL__N_121ldl_solve_wide_kernelIdLi1EEEvPKT_S3_S3_PS1_i":
            rec(90),
        "_ZN12_GLOBAL__N_121ldl_solve_wide_kernelIdLi2EEEvPKT_S3_S3_PS1_i":
            rec(120),
        "_ZN12_GLOBAL__N_121ldl_solve_wide_kernelIfLi1EEEvPKT_S3_S3_PS1_i":
            rec(60),
        "_ZN12_GLOBAL__N_117ldl_factor_kernelEPKdS1_PdS2_Phi": rec(95),
    }
    assert kt.ptxas("ldl_factor", 1, 148, report)["registers"] == 40
    assert kt.ptxas("ldl_factor_batched", 1, 292, report)["registers"] == 38
    assert kt.ptxas("ldl_solve", 2, 148, report)["registers"] == 120
    assert kt.ptxas("ldl_solve_batched", 1, 148, report)["registers"] == 60
    assert kt.ptxas("kkt_residual", 1, 148, report) is None
    assert kt.ptxas("ldl_factor", 1, 128, report)["registers"] == 95
    assert kt.kernel_name("ldl_solve", 2, 148) == \
        "ldl_solve_wide_kernel<double, 2"
    assert kt.kernel_name("ldl_solve", 2, 128) == "ldl_solve_kernel<2"
    assert kt.kernel_name("ldl_factor_batched", 1, 129) == \
        "ldl_factor_wide_kernel<float"


def test_ptxas_of_the_wide_refined_solve_forms():
    """The wide refined solve is a template on the type, R and S, the
    shared form's register slots (ceil(N / 32)) or 0 for the streaming
    form: ptxas gives the instantiation of the form it is given, the
    one refine_form picks on the card (shared at N = 148 and 233,
    streaming at N = 292 and at R = 2 above N = 226)."""
    def rec(regs):
        return {"registers": regs, "spill_stores": 0, "spill_loads": 0}

    name = ("_ZN12_GLOBAL__N_128ldl_solve_refine_wide_kernelIdLi{R}ELi{S}EE"
            "EvPKT_S3_S3_S3_PS1_S4_ii")
    report = {name.format(R=R, S=S): rec(100 + 10 * R + S)
              for R in (1, 2) for S in (0, 5, 6, 7, 8)}
    def regs(R, N, form):
        return kt.ptxas("ldl_solve_refine", R, N, report, form)["registers"]

    assert regs(1, 148, "shared") == 115
    assert regs(2, 148, "shared") == 125
    assert regs(1, 233, "shared") == 118
    assert regs(1, 292, "streaming") == 110
    assert regs(2, 227, "streaming") == 120
    assert kt.kernel_name("ldl_solve_refine", 1, 148) == \
        "ldl_solve_refine_wide_kernel<double, 1"
