"""The wide kernels' wrappers in kkt/ldl.py and kkt/ldl_f32.py, on the
CPU: each calls the narrow kernel at N <= 128 and the wide one above
with the same arguments, and leaves the form (the problem's triangle in
shared memory or streamed) to the launcher in csrc/ldl_wide.cu, which
picks it from N, R and the card's shared memory (the form-by-N tests of
tests/test_torch_cuda.py hold that choice on the card); factor_form,
solve_form and refine_form ask the launchers with the element's bytes,
and kernel_timing.wide_form names the form each wide kernel runs in.
The wrappers' calls into the kernel library are taken with a stand-in
library, so that their arguments are seen without a card."""

import contextlib

import pytest
import torch

from cuclarabel_torch import kernel_timing as kt
from cuclarabel_torch.kkt import ldl, ldl_f32


class _Library:
    """Records the kernel library's calls; every launch succeeds, and
    each function of `answers` returns its value."""

    def __init__(self, **answers):
        self.calls = []
        self.answers = answers

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.answers.get(name, 0)
        return call


@pytest.fixture
def lib(monkeypatch):
    """The stand-in library, taken by the wrappers as if on a card."""
    lib = _Library()
    monkeypatch.setattr(ldl, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ldl_f32, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ldl._build, "load", lambda: lib)
    monkeypatch.setattr(ldl, "_stream", lambda t: 0)
    monkeypatch.setattr(ldl_f32, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


# N at and around each width's edge: the last narrow N, the first wide
# one, the portfolios' 148 and 292, and each shared form's last N on an
# H100 and the next (the factor's 220 / 221, the substitution's 240 /
# 241; in f32 the substitution's 256 / 257 and the factor's 320 / 321)
EDGE_N = (76, 128, 129, 148, 220, 221, 240, 241, 256, 257, 292, 320, 321)


@pytest.mark.parametrize("N", EDGE_N)
def test_factor_calls_the_entry_of_its_width(lib, N):
    B = 3
    K = torch.zeros(B, N, N, dtype=torch.float64)
    reg = torch.ones(B, N, dtype=torch.float64)
    ldl.reset_counts()
    L, Dinv, ok = ldl.ldl_factor(K, reg)
    (name, args), = lib.calls
    assert name == ("cc_ldl_factor_wide" if N > 128 else "cc_ldl_factor")
    # (K, reg, L, Dinv, ok, B, N, stream): no form of its own
    assert len(args) == 8 and args[5:] == (B, N, 0)
    assert args[:5] == tuple(t.data_ptr() for t in (K, reg, L, Dinv, ok))
    assert dict(ldl.LAUNCHES) == {ldl.launch_key("ldl_factor", N, 1): 1}
    assert ldl.launch_key("ldl_factor", N, 1) == (
        "ldl_factor_wide/r1" if N > 128 else "ldl_factor/r1")


@pytest.mark.parametrize("N", EDGE_N)
@pytest.mark.parametrize("R", [1, 2])
def test_solve_calls_the_entry_of_its_width(lib, N, R):
    B = 2
    L = torch.zeros(B, N, N, dtype=torch.float64)
    Dinv = torch.ones(B, N, dtype=torch.float64)
    b = torch.zeros((B, N) if R == 1 else (B, N, R), dtype=torch.float64)
    ldl.reset_counts()
    x = ldl.ldl_solve(L, Dinv, b)
    (name, args), = lib.calls
    assert name == ("cc_ldl_solve_wide" if N > 128 else "cc_ldl_solve")
    # (L, Dinv, b, x, B, N, R, stream): no form of its own
    assert len(args) == 8 and args[4:] == (B, N, R, 0)
    assert args[:4] == tuple(t.data_ptr() for t in (L, Dinv, b, x))
    assert dict(ldl.LAUNCHES) == {ldl.launch_key("ldl_solve", N, R): 1}


@pytest.mark.parametrize("N", EDGE_N)
def test_f32_wrappers_call_the_entry_of_their_width(lib, N):
    B = 2
    K = torch.zeros(B, N, N, dtype=torch.float32)
    b = torch.zeros(B, N, dtype=torch.float32)
    ldl.reset_counts()
    L, Dinv = ldl_f32.ldl_factor_batched(K)
    x = ldl_f32.ldl_solve_batched(L, Dinv, b)
    (fname, fargs), (sname, sargs) = lib.calls
    wide = "_wide" if N > 128 else ""
    assert (fname, sname) == (f"cc_ldl_factor{wide}_f32",
                              f"cc_ldl_solve{wide}_f32")
    # (K, L, Dinv, B, N, stream) and (L, Dinv, b, x, B, N, stream)
    assert fargs == (K.data_ptr(), L.data_ptr(), Dinv.data_ptr(), B, N, 0)
    assert sargs == (L.data_ptr(), Dinv.data_ptr(), b.data_ptr(),
                     x.data_ptr(), B, N, 0)
    assert dict(ldl.LAUNCHES) == {
        ldl.launch_key("ldl_factor_batched", N, 1): 1,
        ldl.launch_key("ldl_solve_batched", N, 1): 1}


@pytest.mark.parametrize("rc,form", [(1, "shared"), (0, "streaming")])
def test_forms_ask_the_launchers(lib, rc, form):
    """factor_form and solve_form pass N (and R) and the element's bytes,
    refine_form N and R; 1 is "shared", 0 "streaming"."""
    lib.answers.update(cc_factor_form_wide=rc, cc_solve_form_wide=rc,
                       cc_refine_form_wide=rc)
    assert ldl.factor_form(148) == form
    assert ldl.factor_form(292, torch.float32) == form
    assert ldl.solve_form(148, 2) == form
    assert ldl.solve_form(257, 1, torch.float32) == form
    assert ldl.refine_form(233, 1) == form
    assert lib.calls == [("cc_factor_form_wide", (148, 8)),
                         ("cc_factor_form_wide", (292, 4)),
                         ("cc_solve_form_wide", (148, 2, 8)),
                         ("cc_solve_form_wide", (257, 1, 4)),
                         ("cc_refine_form_wide", (233, 1))]


def test_a_form_the_device_cannot_answer_raises(lib):
    lib.answers.update(cc_factor_form_wide=-3, cc_solve_form_wide=-3)
    with pytest.raises(RuntimeError, match="CUDA error 3"):
        ldl.factor_form(148)
    with pytest.raises(RuntimeError, match="CUDA error 3"):
        ldl.solve_form(148, 1)


@pytest.mark.parametrize("name,R,N,ask", [
    ("ldl_factor", 1, 148, ("cc_factor_form_wide", (148, 8))),
    ("ldl_factor_batched", 1, 292, ("cc_factor_form_wide", (292, 4))),
    ("ldl_solve", 2, 241, ("cc_solve_form_wide", (241, 2, 8))),
    ("ldl_solve_batched", 1, 148, ("cc_solve_form_wide", (148, 1, 4))),
    ("ldl_solve_refine", 2, 226, ("cc_refine_form_wide", (226, 2))),
    ("kkt_residual", 1, 148, None),
    ("ldl_factor", 1, 76, None)])
def test_kernel_timing_names_each_wide_form(lib, name, R, N, ask):
    """kernel_timing.wide_form asks the launcher of each wide kernel that
    has forms (none for the residual or a narrow form)."""
    lib.answers.update(cc_factor_form_wide=1, cc_solve_form_wide=1,
                       cc_refine_form_wide=1)
    assert kt.wide_form(name, N, R) == (None if ask is None else "shared")
    assert lib.calls == ([] if ask is None else [ask])


def test_ptxas_of_the_wide_shared_forms():
    """The wide factor is a template on the type and F (1: shared), the
    substitution on the type, R and S (the shared form's slots, 0 for
    streaming): ptxas gives the instantiation of the form it is given."""
    def rec(regs):
        return {"registers": regs, "spill_stores": 0, "spill_loads": 0}

    factor = ("_ZN12_GLOBAL__N_122ldl_factor_wide_kernelI{T}Li{F}EEEvPKT_S3_"
              "PS1_S4_Phi")
    solve = ("_ZN12_GLOBAL__N_121ldl_solve_wide_kernelI{T}Li{R}ELi{S}EEEvPKT_"
             "S3_S3_PS1_i")
    report = {factor.format(T=T, F=F): rec(10 * F + (T == "f"))
              for T in "df" for F in (0, 1)}
    report.update({solve.format(T="d", R=R, S=S): rec(100 + 10 * R + S)
                   for R in (1, 2) for S in (0, 5, 6, 7, 8)})
    report.update({solve.format(T="f", R=1, S=S): rec(200 + S)
                   for S in (0, 5, 8)})

    def regs(name, R, N, form):
        return kt.ptxas(name, R, N, report, form)["registers"]

    assert regs("ldl_factor", 1, 148, "shared") == 10
    assert regs("ldl_factor", 1, 221, "streaming") == 0
    assert regs("ldl_factor_batched", 1, 320, "shared") == 11
    assert regs("ldl_factor_batched", 1, 321, "streaming") == 1
    assert regs("ldl_solve", 1, 148, "shared") == 115
    assert regs("ldl_solve", 2, 240, "shared") == 128
    assert regs("ldl_solve", 2, 241, "streaming") == 120
    assert regs("ldl_solve_batched", 1, 256, "shared") == 208
    assert regs("ldl_solve_batched", 1, 257, "streaming") == 200


@pytest.mark.parametrize("N,R,fn", [
    (76, 1, "cc_ldl_solve_refine"),
    (148, 1, "cc_ldl_solve_refine_wide"),
    (233, 1, "cc_ldl_solve_refine_wide"),
    (234, 1, "cc_ldl_solve_refine_wide"),
    (226, 2, "cc_ldl_solve_refine_wide"),
    (227, 2, "cc_ldl_solve_refine_wide"),
    (292, 2, "cc_ldl_solve_refine_wide")])
def test_launcher_passes_the_form(lib, N, R, fn):
    B = 2
    K = torch.zeros(B, N, N, dtype=torch.float64)
    D = torch.ones(B, N, dtype=torch.float64)
    b = torch.zeros((B, N) if R == 1 else (B, N, R), dtype=torch.float64)
    ldl.reset_counts()
    ldl.ldl_solve_refine(K, K, D, b, 1)
    (name, args), = lib.calls
    assert name == fn
    # (K, L, Dinv, b, x, r, B, N, R, npass, stream): no form of its own
    assert len(args) == 11 and args[6:10] == (B, N, R, 1)
    assert dict(ldl.LAUNCHES) == {ldl.launch_key("ldl_solve_refine", N, R): 1}
    with pytest.raises(TypeError):
        ldl.ldl_solve_refine(K, K, D, b, 1, form="shared")
