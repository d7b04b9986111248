"""The port's CUDA kernels and its batched solve on the card.

These need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one.  On a machine with a card and without JAX, run them with

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

The kernels are held against their plain PyTorch versions on the same
card tensors: the factor and the substitution, f64 and f32, bit for bit
(the kernels are built with -fmad=false and round every operation as the
plain versions do), the residual and the refined solve within 1e-12
relative (other summation orders), at the main shapes, at the edges of
the substitution's 32-row panels and around the factor's 8-pivot panels
and 4 x 4 tiles, and a pivot that cancels to exactly zero; the residual
bit for bit with the refined solve's.  The same for the wide forms that
run above N = 128 (csrc/ldl_wide.cu), at N from 129 to 292, with both
forms of the wide factor, substitution and refined solve (the triangle
in shared memory, or streamed) on either side of each form's edge and
the launchers' choice of form by N, a 2-RHS residual and refined solve
bit for bit two 1-RHS ones, a problem alone bit for bit what it is in
a batch of 4096, and three solves of the nass = 64 batch giving one
digest under "pallas" and under "lu" (ROADMAP F14).  The issue-rate probes' kernels
(csrc/probes.cu) are held to their plain versions bit for bit.  The
sparse paths, which run no kernel of csrc/, are held to the CPU: the
multifrontal factor and solve within 1e-12 relative and bitwise equal
to themselves on the card, SparseSolver and BatchSparseSolver with the
CPU's statuses and iterations, and the native library built for
Solver(direct_solve_method="qdldl").  The block-arrow ShardedSolver on one
card is held to the CPU; with 2 or more cards, ShardedSolver over two
cards to one card's objective within 1e-8, and BatchSolver and
BatchSparseSolver over two cards slab by slab to one-card batches, bit
for bit (these skip, saying so, on a host with one card)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LDL^T kernels have no CPU mode")
    return torch.device("cuda")


def _kkt(rng, B, n, m, dev):
    N = n + m
    A = rng.standard_normal((B, m, n))
    G = rng.standard_normal((n, n)) / np.sqrt(n)
    K = np.zeros((B, N, N))
    Hs = 10.0 ** rng.uniform(-3, 3, (B, m))
    K[:, :m, :m] = -Hs[:, :, None] * np.eye(m)
    K[:, :m, m:] = A
    K[:, m:, :m] = np.transpose(A, (0, 2, 1))
    K[:, m:, m:] = G @ G.T
    reg = np.broadcast_to(np.concatenate([-np.ones(m), np.ones(n)]) * 1e-8,
                          (B, N)).copy()
    return (torch.tensor(K, device=dev), torch.tensor(reg, device=dev))


@pytest.mark.parametrize("n,m", [(5, 8), (33, 43), (56, 72)])
@pytest.mark.parametrize("R", [1, 2])
def test_kernels_match_plain(dev, n, m, R):
    from cuclarabel_torch.kkt import ldl

    rng = np.random.default_rng(n + m + R)
    B = 37
    K, reg = _kkt(rng, B, n, m, dev)
    shape = (B, n + m) if R == 1 else (B, n + m, R)
    b = torch.tensor(rng.standard_normal(shape), device=dev)
    ldl.reset_counts()

    L, Dinv, ok = ldl.ldl_factor(K, reg)
    Lp, Dinvp, okp = ldl.ldl_factor_plain(K, reg)
    assert torch.equal(L, Lp) and torch.equal(Dinv, Dinvp)
    assert torch.equal(ok, okp) and bool(ok.all())

    x = ldl.ldl_solve(L, Dinv, b)
    assert torch.equal(x, ldl.ldl_solve_plain(L, Dinv, b))

    r = ldl.kkt_residual(K, x, b)
    torch.testing.assert_close(r, ldl.kkt_residual_plain(K, x, b),
                               rtol=1e-12, atol=1e-12)
    for npass in (0, 1, 2):
        xr, rr = ldl.ldl_solve_refine(K, L, Dinv, b, npass)
        xp, rp = ldl.ldl_solve_refine_plain(K, L, Dinv, b, npass)
        torch.testing.assert_close(xr, xp, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(rr, ldl.kkt_residual_plain(K, xr, b),
                                   rtol=0, atol=1e-11)
    torch.cuda.synchronize()
    assert ldl.LAUNCHES[f"ldl_solve_refine/r{R}"] == 3


PANEL_EDGES = (1, 2, 31, 32, 33, 63, 64, 65, 76, 96, 127, 128)


@pytest.mark.parametrize("N", PANEL_EDGES)
@pytest.mark.parametrize("B", [1, 3, 300])
@pytest.mark.parametrize("R", [1, 2])
def test_warp_kernels_at_panel_edges(dev, N, B, R):
    """ldl_solve and ldl_solve_refine run one warp per problem, lane l
    owning rows l + 32 q: N at and around each 32-row panel edge, B = 1
    and more problems than SMs.  The substitution bit for bit with plain,
    the refined solve within 1e-12 of plain for npass 0-3 and its r
    within 1e-11 of b - K x, and bit for bit with kkt_residual's.  K
    carries junk above the diagonal: only its lower triangle may be
    read."""
    from cuclarabel_torch.kkt import ldl

    rng = np.random.default_rng(1000 * N + 10 * B + R)
    m = (N + 1) // 2
    K, reg = _kkt(rng, B, N - m, m, dev)
    L, Dinv, ok = ldl.ldl_factor(K, reg)
    assert bool(ok.all())
    Kj = K + torch.triu(torch.tensor(rng.standard_normal((B, N, N)),
                                     device=dev), 1) * 1e3
    shape = (B, N) if R == 1 else (B, N, R)
    b = torch.tensor(rng.standard_normal(shape), device=dev)
    x = ldl.ldl_solve(L, Dinv, b)
    assert torch.equal(x, ldl.ldl_solve_plain(L, Dinv, b))
    for npass in range(4):
        xr, rr = ldl.ldl_solve_refine(Kj, L, Dinv, b, npass)
        xp, _ = ldl.ldl_solve_refine_plain(K, L, Dinv, b, npass)
        torch.testing.assert_close(xr, xp, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(rr, ldl.kkt_residual_plain(K, xr, b),
                                   rtol=0, atol=1e-11)
        # the fused residual sums in kkt_residual's order
        assert torch.equal(rr, ldl.kkt_residual(K, xr, b))
    torch.cuda.synchronize()


@pytest.mark.parametrize("N", [33, 76, 128, 129, 148, 292])
@pytest.mark.parametrize("R", [1, 2])
def test_warp_kernels_keep_problems_apart(dev, N, R):
    """A NaN in one problem's b, or a non-finite D^-1 of one problem,
    leaves every other problem's x and r as they were (above N = 128 in
    the wide forms)."""
    from cuclarabel_torch.kkt import ldl

    rng = np.random.default_rng(N + R)
    B, m = 5, (N + 1) // 2
    K, reg = _kkt(rng, B, N - m, m, dev)
    L, Dinv, _ = ldl.ldl_factor(K, reg)
    shape = (B, N) if R == 1 else (B, N, R)
    b = torch.tensor(rng.standard_normal(shape), device=dev)
    x0 = ldl.ldl_solve(L, Dinv, b)
    xr0, rr0 = ldl.ldl_solve_refine(K, L, Dinv, b, 2)
    b_nan = b.clone()
    b_nan[2, N // 2] = float("nan")
    d_inf = Dinv.clone()
    d_inf[2, N - 1] = float("inf")
    others = [0, 1, 3, 4]
    for bb, dd in ((b_nan, Dinv), (b, d_inf)):
        x = ldl.ldl_solve(L, dd, bb)
        xr, rr = ldl.ldl_solve_refine(K, L, dd, bb, 2)
        assert torch.equal(x[others], x0[others])
        assert torch.equal(xr[others], xr0[others])
        assert torch.equal(rr[others], rr0[others])
        assert not bool(torch.isfinite(xr[2]).all())


FACTOR_EDGES = (1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 76, 96,
                127, 128)


def _junk(rng, K):
    """K with 1e3-scale junk above the diagonal, which the kernels that
    take a symmetric K must not read."""
    junk = torch.tensor(rng.standard_normal(tuple(K.shape)), device=K.device)
    return K + torch.triu(junk, 1) * 1e3


@pytest.mark.parametrize("N", FACTOR_EDGES)
@pytest.mark.parametrize("B", [1, 3, 300])
def test_factor_at_panel_and_tile_edges(dev, N, B):
    """ldl_factor eliminates in panels of 8 pivots and updates in 4 x 4
    tiles: N at and around each edge, B = 1 and more problems than SMs.
    Bit for bit with plain on a K with junk above the diagonal, and the
    same factor as without the junk."""
    from cuclarabel_torch.kkt import ldl

    rng = np.random.default_rng(100 * N + B)
    m = (N + 1) // 2
    K, reg = _kkt(rng, B, N - m, m, dev)
    Kj = _junk(rng, K)
    L, Dinv, ok = ldl.ldl_factor(Kj, reg)
    Lp, Dinvp, okp = ldl.ldl_factor_plain(Kj, reg)
    assert torch.equal(L, Lp) and torch.equal(Dinv, Dinvp)
    assert torch.equal(ok, okp) and bool(ok.all())
    assert bool((L.triu() == 0).all())
    L0, Dinv0, _ = ldl.ldl_factor(K, reg)
    assert torch.equal(L, L0) and torch.equal(Dinv, Dinv0)


@pytest.mark.parametrize("N", [1, 9, 76, 128, 148, 292])
def test_factor_zero_pivot_stays_in_its_problem(dev, N):
    """A zero pivot in one problem (row j of its lower triangle and reg_j
    zero, so D_j = 0 exactly) sets ok false there alone; every other
    problem's L and D^-1 are as without it."""
    from cuclarabel_torch.kkt import ldl

    rng = np.random.default_rng(N)
    B, m, bad, j = 5, (N + 1) // 2, 2, N // 2
    K, reg = _kkt(rng, B, N - m, m, dev)
    L0, Dinv0, _ = ldl.ldl_factor(K, reg)
    K[bad, j, :j + 1] = 0.0
    reg[bad, j] = 0.0
    L, Dinv, ok = ldl.ldl_factor(K, reg)
    others = [i for i in range(B) if i != bad]
    assert not bool(ok[bad]) and bool(ok[others].all())
    assert torch.equal(ok, ldl.ldl_factor_plain(K, reg)[2])
    assert not bool(torch.isfinite(Dinv[bad, j]))
    assert torch.equal(L[others], L0[others])
    assert torch.equal(Dinv[others], Dinv0[others])


@pytest.mark.parametrize("N", FACTOR_EDGES)
@pytest.mark.parametrize("B", [1, 3, 300])
@pytest.mark.parametrize("R", [1, 2])
def test_residual_reads_the_lower_triangle(dev, N, B, R):
    """kkt_residual takes a symmetric K and reads its lower triangle:
    junk above the diagonal changes nothing; r within 1e-12 of plain, and
    bit for bit the residual that ldl_solve_refine returns."""
    from cuclarabel_torch.kkt import ldl

    rng = np.random.default_rng(10 * N + B + R)
    m = (N + 1) // 2
    K, reg = _kkt(rng, B, N - m, m, dev)
    Kj = _junk(rng, K)
    L, Dinv, _ = ldl.ldl_factor(K, reg)
    shape = (B, N) if R == 1 else (B, N, R)
    b = torch.tensor(rng.standard_normal(shape), device=dev)
    x = torch.tensor(rng.standard_normal(shape), device=dev)
    r = ldl.kkt_residual(Kj, x, b)
    assert torch.equal(r, ldl.kkt_residual(K, x, b))
    torch.testing.assert_close(r, ldl.kkt_residual_plain(Kj, x, b),
                               rtol=1e-12, atol=1e-12)
    xr, rr = ldl.ldl_solve_refine(Kj, L, Dinv, b, 1)
    assert torch.equal(rr, ldl.kkt_residual(Kj, xr, b))
    torch.cuda.synchronize()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from cuclarabel_torch.kkt import ldl

    K, reg = _kkt(np.random.default_rng(0), 2, 5, 8, dev)
    with pytest.raises(TypeError):
        ldl.ldl_factor(K.float(), reg.float())
    with pytest.raises(ValueError):
        ldl.ldl_factor(K.transpose(1, 2), reg)  # not contiguous
    empty = torch.zeros(1, 0, 0, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):  # N >= 1; any N above (wide forms)
        ldl.ldl_factor(empty, torch.zeros(1, 0, dtype=torch.float64,
                                          device=dev))
    with pytest.raises(ValueError):
        ldl.ldl_solve(K, reg, torch.zeros(2, 13, 3, dtype=torch.float64,
                                          device=dev))


# the wide forms (csrc/ldl_wide.cu, N > 128): around the first N they
# take, the portfolio's N = 148, the 32-row panels of the substitution
# (160, 169), the largest N at which each kernel keeps its triangle in
# shared memory on an H100 and the next (its launcher's form: the factor
# 220, 221; the refined solve 226, 227 at R = 2 and 233, 234 at R = 1;
# the substitution 240, 241), around 237, 238, and the nass = 128
# portfolio's N = 292
WIDE_N = (129, 148, 160, 169, 220, 221, 226, 227, 233, 234, 237, 238, 240,
          241, 292)


@pytest.mark.parametrize("N", WIDE_N)
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("R", [1, 2])
def test_wide_kernels_match_plain(dev, N, B, R):
    """Each wide form against its plain version: the factor and the
    substitution bit for bit, the residual and the refined solve (npass
    0, 1, 2, in the form refine_form picks at N, R) within 1e-12, the
    refined solve's r bit for bit the wide residual's on its x, and a
    2-RHS residual and refined solve bit for bit two 1-RHS ones; K
    carries junk above its diagonal, which no kernel may read; the
    launches counted under the wide keys."""
    from cuclarabel_torch.kkt import ldl

    rng = np.random.default_rng(7 * N + B + R)
    m = (N + 1) // 2
    K, reg = _kkt(rng, B, N - m, m, dev)
    Kj = _junk(rng, K)
    shape = (B, N) if R == 1 else (B, N, R)
    b = torch.tensor(rng.standard_normal(shape), device=dev)
    ldl.reset_counts()
    L, Dinv, ok = ldl.ldl_factor(Kj, reg)
    Lp, Dinvp, okp = ldl.ldl_factor_plain(Kj, reg)
    assert torch.equal(L, Lp) and torch.equal(Dinv, Dinvp)
    assert torch.equal(ok, okp) and bool(ok.all())
    assert bool((L.triu() == 0).all())
    x = ldl.ldl_solve(L, Dinv, b)
    assert torch.equal(x, ldl.ldl_solve_plain(L, Dinv, b))
    r = ldl.kkt_residual(Kj, x, b)
    assert torch.equal(r, ldl.kkt_residual(K, x, b))
    torch.testing.assert_close(r, ldl.kkt_residual_plain(Kj, x, b),
                               rtol=1e-12, atol=1e-12)
    for npass in (0, 1, 2):
        xr, rr = ldl.ldl_solve_refine(Kj, L, Dinv, b, npass)
        xp, rp = ldl.ldl_solve_refine_plain(Kj, L, Dinv, b, npass)
        torch.testing.assert_close(xr, xp, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(rr, rp, rtol=1e-12, atol=1e-12)
        assert torch.equal(rr, ldl.kkt_residual(Kj, xr, b))
        if R == 2:  # each right-hand side as one alone
            for t in range(2):
                bt = b[:, :, t].contiguous()
                assert torch.equal(r[:, :, t], ldl.kkt_residual(
                    Kj, x[:, :, t].contiguous(), bt))
                x1, r1 = ldl.ldl_solve_refine(Kj, L, Dinv, bt, npass)
                # a pass is accepted per right-hand side, as alone
                assert torch.equal(x1, xr[:, :, t])
                assert torch.equal(r1, rr[:, :, t])
    torch.cuda.synchronize()
    assert ldl.LAUNCHES["ldl_factor_wide/r1"] == 1
    assert ldl.LAUNCHES[f"ldl_solve_refine_wide/r{R}"] == 3
    assert not any("/" in k and "_wide/" not in k for k in ldl.LAUNCHES)


# the largest N at which the wide refined solve keeps L in shared memory
# on an H100 (227 KB a block), by R
LARGEST_SHARED = {1: 233, 2: 226}


@pytest.mark.parametrize("R", [1, 2])
def test_wide_refine_form_by_n(dev, R):
    """The launcher keeps L in shared memory from N = 129 up to the
    largest N whose triangle and vectors fit one block's shared memory,
    and streams L above, at N = 292 too (test_wide_kernels_match_plain
    holds both forms against plain on each side of the edge)."""
    from cuclarabel_torch.kkt import ldl

    top = LARGEST_SHARED[R]
    for N in (129, 148, top):
        assert ldl.refine_form(N, R) == "shared"
    for N in (top + 1, 237, 256, 292, 600):
        assert ldl.refine_form(N, R) == "streaming"


# the largest N at which the wide factor and the wide substitution keep
# the problem's triangle in shared memory on an H100 (227 KB a block): the
# factor's blocked layout to N = 220 in f64 and its block of 10 warps to
# N = 320 in f32; the substitution's packed triangle to N = 240 in f64
# and its instantiations (8 register slots) to N = 256 in f32
LARGEST_SHARED_FACTOR = {"f64": 220, "f32": 320}
LARGEST_SHARED_SOLVE = {"f64": 240, "f32": 256}
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_wide_factor_form_by_n(dev, dtype):
    """The factor's launcher keeps K's triangle in shared memory from
    N = 129 up to the largest N whose layout fits one block's shared
    memory, and streams the trailing triangle through L's rows above, at
    N = 292 too in f64 (test_wide_kernels_match_plain and
    test_f32_kernels_match_plain hold both forms against plain on each
    side of the edge)."""
    from cuclarabel_torch.kkt import ldl

    top, t = LARGEST_SHARED_FACTOR[dtype], DTYPES[dtype]
    for N in (129, 148, top):
        assert ldl.factor_form(N, t) == "shared"
    for N in (top + 1, top + 40, 600):
        assert ldl.factor_form(N, t) == "streaming"
    if dtype == "f64":
        assert ldl.factor_form(292, t) == "streaming"


@pytest.mark.parametrize("dtype,R", [("f64", 1), ("f64", 2), ("f32", 1)])
def test_wide_solve_form_by_n(dev, dtype, R):
    """The substitution's launcher keeps L in shared memory from N = 129
    up to the largest N that fits, whatever R (x lives in registers),
    and streams L above, at N = 292 too."""
    from cuclarabel_torch.kkt import ldl

    top, t = LARGEST_SHARED_SOLVE[dtype], DTYPES[dtype]
    for N in (129, 148, top):
        assert ldl.solve_form(N, R, t) == "shared"
    for N in (top + 1, 292, 600):
        assert ldl.solve_form(N, R, t) == "streaming"


@pytest.mark.parametrize("B", [1, 5, 4096])
def test_segment_sum_matches_plain(dev, B):
    """The segment-sum kernel against its plain version on the CPU (the
    order index_add_ adds in there) bit for bit, on the second-order
    cones of the nass = 32 and 64 portfolios and on segments with gaps;
    a problem's sums the same bits alone and inside the batch; the
    launches counted."""
    from cuclarabel_torch.cones import segsum
    from cuclarabel_torch.cones.layout import build_layout
    from cuclarabel_torch.problems import portfolio_socp

    rng = np.random.default_rng(B)
    cases = [build_layout(tuple(portfolio_socp(nass, 1, seed=7)[3])).soc_seg
             for nass in (32, 64)]
    cases.append(rng.integers(-1, 9, size=300))
    segsum.reset_counts()
    for seg in cases:
        segs, segs_cpu = (segsum.Segments(seg, d) for d in (dev, "cpu"))
        vals = torch.tensor(rng.standard_normal((B, len(seg))))
        got = segsum.segment_sum(vals.to(dev), segs)
        assert torch.equal(got.cpu(), segsum.segment_sum_plain(vals,
                                                               segs_cpu))
        one = segsum.segment_sum(vals[B // 2:B // 2 + 1].to(dev), segs)
        assert torch.equal(one, got[B // 2:B // 2 + 1])
    with pytest.raises(TypeError):
        segsum.segment_sum(vals.float().to(dev), segs)
    torch.cuda.synchronize()
    assert segsum.LAUNCHES["segment_sum"] == 2 * len(cases)


@pytest.mark.parametrize("N", [148, 234, 292])
def test_wide_problem_alone_equals_in_batch(dev, N):
    """A problem's residual and refined solve (R = 1 and 2, npass = 1)
    are the same bits alone (B = 1) and inside a batch of 4096 (1024 at
    N = 292): the wide residual's order of additions depends on N
    alone."""
    from cuclarabel_torch.kkt import ldl

    rng = np.random.default_rng(N)
    B = 4096 if N < 292 else 1024
    m = (N + 1) // 2
    K, reg = _kkt(rng, B, N - m, m, dev)
    L, Dinv, _ = ldl.ldl_factor(K, reg)
    for R in (1, 2):
        shape = (B, N) if R == 1 else (B, N, R)
        b = torch.tensor(rng.standard_normal(shape), device=dev)
        x = torch.tensor(rng.standard_normal(shape), device=dev)
        r = ldl.kkt_residual(K, x, b)
        xr, rr = ldl.ldl_solve_refine(K, L, Dinv, b, 1)
        for k in (0, B // 2, B - 1):
            one = slice(k, k + 1)
            assert torch.equal(ldl.kkt_residual(K[one], x[one], b[one]),
                               r[one])
            x1, r1 = ldl.ldl_solve_refine(K[one], L[one], Dinv[one],
                                          b[one], 1)
            assert torch.equal(x1, xr[one]) and torch.equal(r1, rr[one])


def test_wide_batch_repeats_to_the_bit(dev):
    """Three solves of the portfolio at nass = 64 (N = 148), B = 256, in
    one process give one digest under "pallas" and one under "lu", with
    no global deterministic setting (ROADMAP F14: the SOC segment sums
    run in a fixed order)."""
    import cuclarabel_torch as ct
    from cuclarabel_torch import solve_digest
    from cuclarabel_torch.problems import portfolio_socp

    assert not torch.are_deterministic_algorithms_enabled()
    A, qs, bs, cones = portfolio_socp(64, 256, seed=7)
    for method in ("pallas", "lu"):
        got = {solve_digest.digest(ct.BatchSolver(
            None, qs, A, bs, cones, kkt_solve_method=method).solve())[
                "sha256"] for _ in range(3)}
        assert len(got) == 1, (method, got)


def test_wide_batch_on_card_matches_cpu(dev):
    """BatchSolver under explicit "pallas" on the portfolio at nass = 64
    (N = 148, the wide forms) on the card against the CPU: the same
    statuses and iterations, x within 1e-7; the wide kernels launched and
    no narrow one."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.kkt import ldl
    from cuclarabel_torch.problems import portfolio_socp

    A, qs, bs, cones = portfolio_socp(64, 6, seed=7)
    ldl.reset_counts()
    got = ct.BatchSolver(None, qs, A, bs, cones,
                         kkt_solve_method="pallas").solve()
    torch.cuda.synchronize()
    launched = dict(ldl.LAUNCHES)
    assert launched.get("ldl_factor_wide/r1", 0) > 0
    assert launched.get("ldl_solve_refine_wide/r1", 0) > 0
    assert all("_wide/" in k for k in launched), launched
    want = ct.BatchSolver(None, qs, A, bs, cones, device="cpu",
                          kkt_solve_method="pallas").solve()
    for g, c in zip(got, want):
        assert g.status == c.status == ct.SolverStatus.SOLVED
        assert abs(g.iterations - c.iterations) <= 1
        assert np.abs(g.x - c.x).max() <= 1e-7 * max(np.abs(c.x).max(), 1.0)


def test_kernels_on_two_devices(dev):
    """The shared-memory attribute is set per device: kernels whose
    launch needs more than 48 KB (the refined solve at N = 76) run on a
    second card after the first."""
    from cuclarabel_torch.kkt import ldl

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(3)
    for d in (torch.device("cuda", 0), torch.device("cuda", 1)):
        K, reg = _kkt(rng, 5, 33, 43, d)
        b = torch.tensor(rng.standard_normal((5, 76)), device=d)
        L, Dinv, _ = ldl.ldl_factor(K, reg)
        xr, _ = ldl.ldl_solve_refine(K, L, Dinv, b, 1)
        xp, _ = ldl.ldl_solve_refine_plain(K, L, Dinv, b, 1)
        torch.testing.assert_close(xr, xp, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("N", [1, 9, 76, 104, 128, 129, 148, 292])
def test_factor_zero_pivot_takes_the_regularization(dev, N):
    """A pivot that cancels to exactly zero (row j of the lower triangle
    zero, K_jj = -reg_j) takes reg_j as its D_j, in the kernel as in the
    plain version, bit for bit; ok stays true."""
    from cuclarabel_torch.kkt import ldl

    rng = np.random.default_rng(N + 1)
    B, m, bad, j = 5, (N + 1) // 2, 2, N // 2
    K, reg = _kkt(rng, B, N - m, m, dev)
    K[bad, j, :j + 1] = 0.0
    K[bad, j, j] = -reg[bad, j]
    L, Dinv, ok = ldl.ldl_factor(K, reg)
    Lp, Dinvp, okp = ldl.ldl_factor_plain(K, reg)
    assert torch.equal(L, Lp) and torch.equal(Dinv, Dinvp)
    assert bool(ok.all()) and bool(okp.all())
    assert float(Dinv[bad, j]) == 1.0 / float(reg[bad, j])


def test_nonsymmetric_batches_on_card_match_cpu(dev):
    """exp_logistic (N = 104) and the genpow family (N = 56) on the card
    against the same batches on the CPU: the same statuses, objectives
    within 1e-7 relative (the iterations may differ: the CPU rounds log,
    exp and sums otherwise, and exp_logistic amplifies rounding)."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.kkt import ldl
    from cuclarabel_torch.problems import exp_logistic, genpow_family

    for data in (exp_logistic(4, 10, 6, 5), genpow_family(8, 6, 9)[:5]):
        ldl.reset_counts()
        gpu = ct.BatchSolver(*data).solve()
        assert not ldl.PLAIN_CALLS and ldl.LAUNCHES["ldl_factor/r1"] > 0
        cpu = ct.BatchSolver(*data, device="cpu").solve()
        for g, c in zip(gpu, cpu):
            assert g.status == c.status == ct.SolverStatus.SOLVED
            assert abs(g.obj_val - c.obj_val) <= 1e-7 * abs(c.obj_val)


def test_psd_batches_on_card_match_cpu(dev):
    """The max-cut relaxations (N = 90) and the PSD min-eig family
    (N = 73) on the card against the same batches on the CPU: all
    SOLVED, the same iterations, objectives within 1e-7 relative; the
    kernels ran and no plain version did."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.kkt import ldl
    from cuclarabel_torch.problems import maxcut_sdp, psd_min_eig

    for data in (maxcut_sdp(12, 6, 11)[:5], psd_min_eig(8, 6, 3)[:5]):
        ldl.reset_counts()
        gpu = ct.BatchSolver(*data).solve()
        assert not ldl.PLAIN_CALLS and ldl.LAUNCHES["ldl_factor/r1"] > 0
        assert ldl.LAUNCHES["ldl_solve_refine/r2"] > 0  # the LP init
        cpu = ct.BatchSolver(*data, device="cpu").solve()
        for g, c in zip(gpu, cpu):
            assert g.status == c.status == ct.SolverStatus.SOLVED
            assert g.iterations == c.iterations
            assert abs(g.obj_val - c.obj_val) <= 1e-7 * abs(c.obj_val)


@pytest.mark.parametrize("r", [3, 6, 8, 12])
def test_psd_linalg_on_card_matches_numpy(dev, r):
    """torch.linalg's batched eigvalsh, eigh, cholesky_ex and svd on the
    card, as cones/psd.py calls them on (B, k, r, r) stacks, against
    numpy f64: within 1e-12 of the matrix's norm."""
    rng = np.random.default_rng(r)
    G = rng.standard_normal((512, 2, r, r))
    S = G @ np.swapaxes(G, -1, -2) + 1e-3 * np.eye(r)
    nrm = np.linalg.norm(S, ord=2, axis=(-2, -1))
    t = torch.tensor(S, device=dev)
    e = torch.linalg.eigvalsh(t).cpu().numpy()
    assert (np.abs(e - np.linalg.eigvalsh(S)).max(-1) / nrm).max() < 1e-12
    lam, V = (a.cpu().numpy() for a in torch.linalg.eigh(t))
    rec = (V * lam[..., None, :]) @ np.swapaxes(V, -1, -2)
    assert (np.abs(rec - S).max(axis=(-2, -1)) / nrm).max() < 1e-12
    L, info = torch.linalg.cholesky_ex(t)
    assert not bool(info.any())
    L = L.cpu().numpy()
    rec = L @ np.swapaxes(L, -1, -2)
    assert (np.abs(rec - S).max(axis=(-2, -1)) / nrm).max() < 1e-12
    U, sv, Vh = (a.cpu().numpy() for a in torch.linalg.svd(
        torch.tensor(G, device=dev)))
    gn = np.linalg.norm(G, ord=2, axis=(-2, -1))
    want = np.linalg.svd(G, compute_uv=False)
    assert (np.abs(sv - want).max(-1) / gn).max() < 1e-12
    rec = (U * sv[..., None, :]) @ Vh
    assert (np.abs(rec - G).max(axis=(-2, -1)) / gn).max() < 1e-12


def test_batch_solver_on_card_matches_cpu(dev):
    import cuclarabel_torch as ct
    from cuclarabel_torch.kkt import ldl
    from cuclarabel_torch.problems import portfolio_socp

    A, q, b, cones = portfolio_socp(nass=8, batch=6, seed=2)
    ldl.reset_counts()
    gpu = ct.BatchSolver(None, q, A, b, cones).solve()
    assert not ldl.PLAIN_CALLS and ldl.LAUNCHES["ldl_factor/r1"] > 0
    cpu = ct.BatchSolver(None, q, A, b, cones, device="cpu").solve()
    for g, c in zip(gpu, cpu):
        assert g.status == c.status == ct.SolverStatus.SOLVED
        assert abs(g.obj_val - c.obj_val) <= 1e-7 * abs(c.obj_val)


@pytest.mark.parametrize("N,B", [(16, 5), (128, 37), (129, 5), (148, 37),
                                 (256, 3), (257, 3), (292, 3), (320, 3),
                                 (321, 3)])
def test_f32_kernels_match_plain(dev, N, B):
    """ldl_factor_batched / ldl_solve_batched (csrc/ldl_f32.cu; above
    N = 128 the wide forms of csrc/ldl_wide.cu, on both sides of the
    substitution's shared-memory edge, 256 / 257, and the factor's,
    320 / 321) on quasidefinite K as tests/test_pallas_ldl.py builds
    them."""
    from cuclarabel_torch.kkt import ldl, ldl_f32

    rng = np.random.default_rng(N + B)
    n = N // 2
    m = N - n
    Ks = []
    for _ in range(B):
        F = rng.standard_normal((n, n))
        A = rng.standard_normal((m, n))
        Ks.append(np.block([[F @ F.T + 0.1 * np.eye(n), A.T],
                            [A, -np.diag(rng.random(m) + 0.5)]]))
    K = torch.tensor(np.stack(Ks), dtype=torch.float32, device=dev)
    b = torch.tensor(rng.standard_normal((B, N)), dtype=torch.float32,
                     device=dev)
    ldl.reset_counts()
    L, Dinv = ldl_f32.ldl_factor_batched(K)
    x = ldl_f32.ldl_solve_batched(L, Dinv, b)
    torch.cuda.synchronize()
    assert dict(ldl.LAUNCHES) == {
        ldl.launch_key("ldl_factor_batched", N, 1): 1,
        ldl.launch_key("ldl_solve_batched", N, 1): 1}
    assert L.dtype == Dinv.dtype == x.dtype == torch.float32
    Lp, Dinvp = ldl_f32.ldl_factor_batched_plain(K)
    assert torch.equal(L, Lp) and torch.equal(Dinv, Dinvp)
    assert torch.equal(x, ldl_f32.ldl_solve_batched_plain(L, Dinv, b))
    D = 1.0 / Dinv.double()
    assert bool(((D > 0).sum(dim=1) == n).all())
    assert bool(((D < 0).sum(dim=1) == m).all())


def test_solver_defaults_to_cuda(dev):
    import cuclarabel_torch as ct
    from cuclarabel_torch.kkt import ldl

    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A0 = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    data = (P, np.ones(2), np.vstack([-A0, A0]),
            np.array([-1.0, 0.0, 0.0, 1.0, 0.7, 0.7]),
            [ct.NonnegativeConeT(3), ct.NonnegativeConeT(3)])
    ldl.reset_counts()
    solver = ct.Solver(*data)
    assert solver.device.type == "cuda"
    got = solver.solve()
    assert not ldl.PLAIN_CALLS and ldl.LAUNCHES["ldl_factor/r1"] > 0
    want = ct.Solver(*data, device="cpu").solve()
    assert got.status == want.status == ct.SolverStatus.SOLVED
    assert got.iterations == want.iterations
    assert abs(got.obj_val - want.obj_val) <= 1e-7 * abs(want.obj_val)


def test_staged_compaction_on_card_matches_plain(dev):
    """Staged compaction at B = 300 on the portfolio SOCP: every problem
    with the plain path's status and iterations, stage 2 run."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import portfolio_socp

    A, q, b, cones = portfolio_socp(nass=32, batch=300, seed=7)
    plain = ct.BatchSolver(None, q, A, b, cones, batch_compaction=0.0)
    staged = ct.BatchSolver(None, q, A, b, cones, batch_compaction=0.9)
    want, got = plain.solve(), staged.solve()
    assert staged.last_compaction["remainder"] > 0
    for g, w in zip(got, want):
        assert g.status == w.status == ct.SolverStatus.SOLVED
        assert g.iterations == w.iterations
        assert abs(g.obj_val - w.obj_val) <= 1e-9 * abs(w.obj_val)


@pytest.mark.parametrize("quorum", [0.0, 0.5])
def test_batch_warm_start_on_card(dev, quorum):
    """A warm re-solve after q *= 1.01 takes fewer iterations in total
    than a cold one, to the same objectives."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import portfolio_socp

    A, q, b, cones = portfolio_socp(nass=32, batch=64, seed=3)
    slv = ct.BatchSolver(None, q, A, b, cones, batch_compaction=quorum)
    prev = slv.solve()
    slv.update_data(q=q * 1.01)
    warm = slv.solve(warm_start=tuple(
        np.stack([getattr(s, f) for s in prev]) for f in ("x", "s", "z")))
    cold = slv.solve()
    assert all(s.status == ct.SolverStatus.SOLVED for s in warm)
    for w, c in zip(warm, cold):
        assert abs(w.obj_val - c.obj_val) <= 1e-6 * max(abs(c.obj_val), 1)
    assert sum(s.iterations for s in warm) < sum(s.iterations for s in cold)


@pytest.mark.parametrize("method", ["qr", "inverse"])
@pytest.mark.parametrize("nass", [32, 64])
def test_qr_and_inverse_on_card(dev, method, nass):
    """The library backends on the card take the CPU's iterations."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import portfolio_socp

    A, q, b, cones = portfolio_socp(nass=nass, batch=1, seed=7)
    data = (None, q[0], A, b[0], cones)
    got = ct.Solver(*data, kkt_solve_method=method).solve()
    want = ct.Solver(*data, kkt_solve_method=method, device="cpu").solve()
    assert got.status == want.status == ct.SolverStatus.SOLVED
    assert got.iterations == want.iterations
    assert abs(got.obj_val - want.obj_val) <= 1e-7 * abs(want.obj_val)


def test_profile_phases_on_card(dev):
    import cuclarabel_torch as ct
    from cuclarabel_torch.problems import portfolio_socp

    A, q, b, cones = portfolio_socp(nass=32, batch=1, seed=7)
    solver = ct.Solver(None, q[0], A, b[0], cones)
    solver.solve()
    ph = solver.profile_phases()
    assert set(ph) == {"scale_cones", "hs_assembly", "kkt_factor",
                       "kkt_solve", "kkt_solve_pair", "residuals",
                       "step_length"}
    assert all(t > 0.0 for t in ph.values())


def test_device_ms_times_by_events_where_the_profiler_misses(dev):
    """A kernel the profiler did not record (here: under a name no kernel
    has) is timed by CUDA events around each launch, and says so; the
    two measures of one kernel agree within a factor of two."""
    from cuclarabel_torch import kernel_timing as kt

    op = kt.operands(4096, dev=dev)
    fn = kt.calls(op)[("ldl_factor", 1)][0]
    how = {}
    got = kt.device_ms({("f", "ldl_factor_kernel"): fn,
                        ("x", "no_such_kernel"): fn}, 10, timed_by=how)
    assert how[("x", "no_such_kernel")] == "events"
    prof, events = got[("f", "ldl_factor_kernel")], got[("x", "no_such_kernel")]
    assert 0.0 < prof and 0.5 < events / prof < 2.0


@pytest.mark.parametrize("N,B", [(83, 4096), (13, 256), (7, 130)])
def test_probe_chain_matches_plain(dev, N, B):
    """Every P1 variant bit for bit with its plain version, at the
    reference's default, its small shape and an odd N with a ragged B;
    D's output equals A's."""
    from cuclarabel_torch.kkt import ldl
    from cuclarabel_torch.probes import mosaic_probe as p1

    for seed in (N + B, None):
        x, y = p1.inputs((N, N, B), seed, dev)
        ldl.reset_counts()
        outs = {}
        for variant, rows, _ in p1.SWEEP:
            o = p1.chain(x, y, variant, rows)
            outs[p1.name(variant, rows)] = o
            assert torch.equal(o, p1.chain_plain(x, y, variant, rows))
        torch.cuda.synchronize()
        assert all(torch.equal(outs[f"D{r}"], outs["A"])
                   for r in p1.CHUNK_ROWS)
        assert dict(ldl.LAUNCHES) == {f"probe_chain/{k}": 1 for k in outs}


@pytest.mark.parametrize("R,streams", [(8, 1), (32, 1), (128, 1), (512, 1),
                                       (1024, 1), (2048, 1), (8, 4), (32, 4),
                                       (512, 4)])
def test_probe_issue_matches_plain(dev, R, streams):
    from cuclarabel_torch.probes import mosaic_probe as p1
    from cuclarabel_torch.probes import mosaic_probe2 as p2

    x, y = p1.inputs((R, p2.LANES), R + streams, dev)
    o = p2.run(x, y, p2.OPS, streams)
    torch.cuda.synchronize()
    assert torch.equal(o, p2.make_plain(x, y, p2.OPS, streams))


def test_probe_wrappers_reject_mixed_devices_and_dtypes(dev):
    from cuclarabel_torch.probes import mosaic_probe as p1
    from cuclarabel_torch.probes import mosaic_probe2 as p2

    x, y = p1.inputs((5, 5, 128), 0, dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        p1.chain(x, y.cpu(), "A")
    with pytest.raises(TypeError):
        p1.chain(x.double(), y.double(), "B")
    xi, yi = p1.inputs((8, p2.LANES), 0, dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        p2.run(xi.cpu(), yi, p2.OPS, 1)
    with pytest.raises(TypeError):
        p2.run(xi.half(), yi.half(), p2.OPS, 1)


# ---------------------------------------------------------------------
# the sparse paths on the card (the multifrontal is plain torch: held to
# the CPU within 1e-12 relative, and to itself bit for bit)


def _sparse_kkt(seed, n, m):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.1, random_state=np.random.RandomState(1),
                  format="csc") + 0.01 * sp.eye(m, n)
    G = sp.random(n, n, density=0.1, random_state=np.random.RandomState(2),
                  format="csc")
    K = sp.bmat([[G @ G.T + sp.eye(n), A.T],
                 [A, -sp.diags(10.0 ** rng.uniform(-2, 2, m))]], format="csc")
    U = sp.triu(K).tocsc()
    U.sort_indices()
    return (K, U.indptr, U.indices, U.data,
            np.concatenate([np.ones(n), -np.ones(m)]), rng)


@pytest.mark.parametrize("n,m,mw", [(15, 20, 4), (40, 55, 8), (300, 400, 32)])
def test_sparse_factor_and_solve_on_card_match_cpu(dev, n, m, mw):
    from cuclarabel_torch.kkt.sparse_device import SparseDeviceLDL

    K, Ap, Ai, Ax, dsigns, rng = _sparse_kkt(n + m, n, m)
    N = n + m
    Axs = np.stack([Ax * rng.uniform(0.8, 1.25, Ax.size) for _ in range(3)])
    bs = rng.standard_normal((3, N))
    card = SparseDeviceLDL(N, Ap, Ai, dsigns, max_width=mw, device=dev)
    cpu = SparseDeviceLDL(N, Ap, Ai, dsigns, max_width=mw, device="cpu")
    assert card.refactor(Axs).all() and cpu.refactor(Axs).all()
    x, xc = card.solve(bs), cpu.solve(bs)
    assert np.abs(x - xc).max() / np.abs(xc).max() < 1e-12
    # bitwise equal factorizations and solves on the card
    fronts = [f.clone() for f in card._fac["fronts"]]
    dinv = card._fac["Dinv"].clone()
    assert card.refactor(Axs).all()
    for a, b in zip(fronts, card._fac["fronts"]):
        assert torch.equal(a, b)
    assert torch.equal(dinv, card._fac["Dinv"])
    assert np.array_equal(card.solve(bs), x)


def test_sparse_solver_on_card_matches_cpu(dev):
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems

    P, q, A, b, cones = problems.grid_qp(12)
    card = ct.SparseSolver(P, q, A, b, cones)
    assert card.device.type == "cuda"
    s1, s2 = card.solve(), card.solve()
    cpu = ct.SparseSolver(P, q, A, b, cones, device="cpu").solve()
    assert s1.status == cpu.status == ct.SolverStatus.SOLVED
    assert s1.iterations == cpu.iterations
    assert np.abs(s1.x - cpu.x).max() < 1e-9
    assert np.array_equal(s1.x, s2.x) and np.array_equal(s1.z, s2.z)


def test_batch_sparse_solver_on_card_matches_cpu(dev):
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems

    P, q, A, b, cones = problems.grid_qp(8)
    rng = np.random.default_rng(1)
    qs = q * (1.0 + 0.1 * rng.standard_normal((6, q.size)))
    bs = np.tile(b, (6, 1))
    card = ct.BatchSparseSolver(P, qs, A, bs, cones).solve()
    cpu = ct.BatchSparseSolver(P, qs, A, bs, cones, device="cpu").solve()
    for s, c in zip(card, cpu):
        assert s.status == c.status == ct.SolverStatus.SOLVED
        assert s.iterations == c.iterations
        assert np.abs(s.x - c.x).max() < 1e-9


def test_qdldl_solver_on_card(dev):
    import cuclarabel_torch as ct
    from cuclarabel_torch import native

    assert native.build().exists()
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A0 = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    cones = [ct.NonnegativeConeT(3), ct.NonnegativeConeT(3)]
    args = (P, np.ones(2), np.vstack([-A0, A0]),
            np.array([-1.0, 0, 0, 1.0, 0.7, 0.7]), cones)
    sol = ct.Solver(*args, direct_solve_method="qdldl").solve()
    lu = ct.Solver(*args, kkt_solve_method="lu").solve()
    assert sol.status == ct.SolverStatus.SOLVED
    assert sol.iterations == lu.iterations
    np.testing.assert_allclose(sol.x, [0.3, 0.7], atol=1e-7)


# ------------------------------------------------ several cards

@pytest.fixture(scope="module")
def two_cards(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 CUDA devices, this host has {n}")
    return n


@pytest.mark.parametrize("problem", ["sharded_socp", "box_budget_qp"])
def test_arrow_on_card_matches_cpu(dev, problem):
    """ShardedSolver on one card (the block-arrow KKT) against the CPU:
    the same status and iterations, objective within 1e-9 relative, a
    repeat solve bitwise equal, and none of the LDL^T kernels run."""
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems
    from cuclarabel_torch.kkt import ldl

    data = (problems.sharded_socp() if problem == "sharded_socp"
            else problems.box_budget_qp(64, 2048, 1))
    ldl.reset_counts()
    card = ct.ShardedSolver(*data)
    assert card.device.type == "cuda"
    s1, s2 = card.solve(), card.solve()
    assert not ldl.LAUNCHES and not ldl.PLAIN_CALLS
    cpu = ct.ShardedSolver(*data, device="cpu").solve()
    assert s1.status == cpu.status == ct.SolverStatus.SOLVED
    assert s1.iterations == cpu.iterations
    assert abs(s1.obj_val - cpu.obj_val) <= 1e-9 * max(1.0, abs(cpu.obj_val))
    for f in ("x", "s", "z"):
        assert np.array_equal(getattr(s1, f), getattr(s2, f))


def test_too_many_cards_raise(dev):
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems
    from cuclarabel_torch.problems import portfolio_socp

    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"has {have}"):
        ct.ShardedSolver(*problems.sharded_socp(), n_devices=have + 1)
    A, qs, bs, cones = portfolio_socp(nass=4, batch=2 * (have + 1))
    with pytest.raises(ValueError, match=f"has {have}"):
        ct.BatchSolver(None, qs, A, bs, cones, n_devices=have + 1)


def test_model_on_card(dev):
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems

    model, x, (A, q, b, cones) = problems.portfolio_model(8)
    sol = model.solve()
    assert model.solver.device.type == "cuda"
    want = ct.Solver(None, q, A, b, cones).solve()
    assert sol.status == ct.SolverStatus.SOLVED
    assert np.array_equal(x.value, want.x)
    sparse = problems.portfolio_model(8)[0]
    ssol = sparse.solve(backend="sparse")
    assert isinstance(sparse.solver, ct.SparseSolver)
    assert ssol.status == ct.SolverStatus.SOLVED
    assert abs(ssol.obj_val - sol.obj_val) <= 1e-7 * max(1.0,
                                                          abs(sol.obj_val))


def test_sharded_over_cards(two_cards):
    """The QP's rows over two cards: the slabs on cuda:0 and cuda:1, the
    objective within 1e-8 of one card's, a repeat bitwise equal."""
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems

    data = problems.box_budget_qp(64, 2047, 1)  # m = 2048: no padding
    one = ct.ShardedSolver(*data).solve()
    solver = ct.ShardedSolver(*data, n_devices=2)
    assert [a.device.index for a in solver._dev["A"].slabs] == [0, 1]
    s1, s2 = solver.solve(), solver.solve()
    assert s1.status == ct.SolverStatus.SOLVED
    assert abs(s1.obj_val - one.obj_val) <= 1e-8 * max(1.0, abs(one.obj_val))
    for f in ("x", "s", "z"):
        assert np.array_equal(getattr(s1, f), getattr(s2, f))


def test_batch_slabs_over_cards(two_cards):
    """BatchSolver over two cards: K1-K4 launched on each, each slab
    bitwise equal to a one-card batch of it on its card."""
    import cuclarabel_torch as ct
    from cuclarabel_torch.kkt import ldl
    from cuclarabel_torch.problems import portfolio_socp

    A, qs, bs, cones = portfolio_socp(nass=32, batch=512, seed=7)
    solver = ct.BatchSolver(None, qs, A, bs, cones, n_devices=2)
    ldl.reset_counts()
    got = solver.solve()
    for i in (0, 1):
        launched = ldl.LAUNCHES.by_device[f"cuda:{i}"]
        assert launched["ldl_factor/r1"] > 0, launched
        one = ct.BatchSolver(None, qs[i * 256:(i + 1) * 256], A,
                             bs[i * 256:(i + 1) * 256], cones,
                             device=f"cuda:{i}", batch_compaction=0.0).solve()
        for g, o in zip(got[i * 256:(i + 1) * 256], one):
            assert g.status == o.status == ct.SolverStatus.SOLVED
            assert g.iterations == o.iterations
            for f in ("x", "s", "z"):
                assert np.array_equal(getattr(g, f), getattr(o, f))
    assert sum(ldl.LAUNCHES.values()) == sum(
        sum(c.values()) for c in ldl.LAUNCHES.by_device.values())


def test_sparse_batch_slabs_over_cards(two_cards):
    import cuclarabel_torch as ct
    from cuclarabel_torch import problems

    P, q, A, b, cones = problems.grid_qp(8)
    rng = np.random.default_rng(2)
    qs = q * (1.0 + 0.1 * rng.standard_normal((6, q.size)))
    bs = np.tile(b, (6, 1))
    got = ct.BatchSparseSolver(P, qs, A, bs, cones, n_devices=2).solve()
    for i in (0, 1):
        one = ct.BatchSparseSolver(P, qs[i * 3:(i + 1) * 3], A,
                                   bs[i * 3:(i + 1) * 3], cones,
                                   device=f"cuda:{i}").solve()
        for g, o in zip(got[i * 3:(i + 1) * 3], one):
            assert g.status == o.status == ct.SolverStatus.SOLVED
            assert g.iterations == o.iterations
            for f in ("x", "s", "z"):
                assert np.array_equal(getattr(g, f), getattr(o, f))
