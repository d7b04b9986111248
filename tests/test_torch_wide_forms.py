"""The wide refined solve's wrapper in kkt/ldl.py, on the CPU: it calls
the narrow kernel at N <= 128 and the wide one above with the same
arguments, and leaves the form (L in shared memory or streamed) to the
launcher in csrc/ldl_wide.cu, which picks it from N, R and the card's
shared memory (tests/test_torch_cuda.py::test_wide_refine_form_by_n
holds that choice on the card).  The wrapper's call into the kernel
library is taken with a stand-in library, so that its arguments are seen
without a card."""

import contextlib

import pytest
import torch

from cuclarabel_torch.kkt import ldl


class _Library:
    """Records the kernel library's calls; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("N,R,fn", [
    (76, 1, "cc_ldl_solve_refine"),
    (148, 1, "cc_ldl_solve_refine_wide"),
    (233, 1, "cc_ldl_solve_refine_wide"),
    (234, 1, "cc_ldl_solve_refine_wide"),
    (226, 2, "cc_ldl_solve_refine_wide"),
    (227, 2, "cc_ldl_solve_refine_wide"),
    (292, 2, "cc_ldl_solve_refine_wide")])
def test_launcher_passes_the_form(monkeypatch, N, R, fn):
    lib = _Library()
    monkeypatch.setattr(ldl, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ldl._build, "load", lambda: lib)
    monkeypatch.setattr(ldl, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
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
