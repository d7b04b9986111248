"""The fixed-order sums that make a solve repeat to the bit on the card
(ROADMAP F14), on the CPU: the segment sums of cones/segsum.py, whose
plain version adds each segment's entries one by one in ascending order
(the order the kernel of csrc/segsum.cu keeps), against a sum in that
order and against the `index_add_` forms they replace, within 1e-15
relative; the second-order cones' segment sums (cones/ops.py::_seg_sum)
against the reference's on one problem at a time (1e-12, as
tests/test_torch_cones.py); the generalised power cones' scatter
(cones/genpow.py::_scatter_add) and the equilibration's rectification
means (parallel/batch.py::device_equilibrate).  Then solve_digest's
OpTrace, which found the operation that did not repeat.  B = 3 or 5,
never 4 (ROADMAP F2); N <= 22 (F3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuclarabel_tpu.cones.api as ref_api
from cuclarabel_tpu.cones import ops as ref_ops
from cuclarabel_tpu.cones.layout import build_layout as ref_build_layout
import cuclarabel_torch as ct
import cuclarabel_torch.cones.api as api
from cuclarabel_torch import solve_digest
from cuclarabel_torch.cones import genpow, ops, segsum
from cuclarabel_torch.cones.layout import build_layout
from cuclarabel_torch.parallel import batch

TOL = 1e-15
# a cone of 17 entries, as at nass = 64, beside shorter ones: 22 rows
SOC_DIMS = (17, 1, 4)


def _soc_layouts(mod):
    cones = (mod.NonnegativeConeT(2),) + tuple(
        mod.SecondOrderConeT(d) for d in SOC_DIMS[:1]) + (
        mod.ZeroConeT(1),) + tuple(mod.SecondOrderConeT(d)
                                   for d in SOC_DIMS[1:])
    return build_layout(cones) if mod is api else ref_build_layout(cones)


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def _ascending(vals, segs):
    """Each segment's entries added one by one in ascending order, from
    0, in numpy."""
    v = vals.numpy()
    out = np.zeros((v.shape[0], segs.nseg))
    for s, row in enumerate(segs.idx.numpy()):
        for j in row[row >= 0]:
            out[:, s] = out[:, s] + v[:, j]
    return torch.tensor(out)


@pytest.mark.parametrize("B", [3, 5])
def test_soc_segment_sums_match_index_add(B):
    layout = _soc_layouts(api)
    rng = np.random.default_rng(B)
    vals = torch.tensor(rng.standard_normal((B, layout.msoc)))
    seg = torch.as_tensor(layout.soc_seg.astype(np.int64))
    old = vals.new_zeros(B, layout.nsoc).index_add_(1, seg, vals)
    got = ops._seg_sum(layout, vals)
    assert got.shape == (B, layout.nsoc)
    assert _rel(got, old) <= TOL
    # the order the kernel keeps, to the bit
    assert torch.equal(got, _ascending(vals, ops.plan(layout, "cpu")
                                       .soc_segs))
    # a cone's entries stay in their cone
    vals[:, 0] = float("inf")
    got = ops._seg_sum(layout, vals)
    assert torch.isinf(got[:, 0]).all() and torch.isfinite(got[:, 1:]).all()


def test_segments_list_columns_in_order():
    """Segment ids in any order give each segment's columns ascending,
    padded with -1; a column of no segment is left out."""
    segs = segsum.Segments([2, -1, 0, 2, 1, 0, -1, 2], "cpu")
    assert (segs.nseg, segs.width, segs.size) == (3, 3, 6)
    assert segs.idx.dtype == torch.int32
    assert segs.idx.tolist() == [[2, 5, -1], [4, -1, -1], [0, 3, 7]]
    vals = torch.tensor(np.random.default_rng(3).standard_normal((5, 8)))
    segsum.reset_counts()
    got = segsum.segment_sum(vals, segs)
    assert torch.equal(got, _ascending(vals, segs))
    assert dict(segsum.PLAIN_CALLS) == {"segment_sum": 1}
    assert not segsum.LAUNCHES


def test_soc_segment_sums_match_reference():
    """_soc_tail_sumsq, _soc_tail_dot and _soc_full_dot on the batch
    against the reference's on each problem alone."""
    layout, ref_layout = _soc_layouts(api), _soc_layouts(ref_api)
    B = 5
    rng = np.random.default_rng(11)
    u = rng.standard_normal((B, layout.msoc))
    v = rng.standard_normal((B, layout.msoc))
    U, V = torch.tensor(u), torch.tensor(v)
    for got, ref in (
            (ops._soc_tail_sumsq(layout, V),
             lambda i: ref_ops._soc_tail_sumsq(ref_layout, jnp.asarray(v[i]))),
            (ops._soc_tail_dot(layout, U, V),
             lambda i: ref_ops._soc_tail_dot(ref_layout, jnp.asarray(u[i]),
                                             jnp.asarray(v[i]))),
            (ops._soc_full_dot(layout, U, V),
             lambda i: ref_ops._soc_full_dot(ref_layout, jnp.asarray(u[i]),
                                             jnp.asarray(v[i])))):
        want = torch.tensor(np.stack([np.asarray(ref(i)) for i in range(B)]))
        assert float((got - want).abs().max()) <= 1e-12 * max(
            float(want.abs().max()), 1.0)


def test_genpow_scatter_matches_index_add():
    """The unpadded entries alone, each target once, against the padded
    form that added the padding's zeros into each cone's first entry."""
    layout = build_layout((api.NonnegativeConeT(2),
                           api.GenPowerConeT([0.3, 0.7], 2),
                           api.GenPowerConeT([0.2, 0.5, 0.3], 1)))
    p = ops.plan(layout, "cpu")
    B = 3
    rng = np.random.default_rng(4)
    k, d1 = p.gp_idx1.shape
    d2 = p.gp_idx2.shape[1]
    full = torch.tensor(rng.standard_normal((B, layout.m)))
    v1 = torch.tensor(rng.standard_normal((B, k, d1)))
    v2 = torch.tensor(rng.standard_normal((B, k, d2)))
    old = full.index_add(1, p.gp_idx1.flatten(), (v1 * p.gp_m1).reshape(
        B, -1)).index_add(1, p.gp_idx2.flatten(), (v2 * p.gp_m2).reshape(
            B, -1))
    got = genpow._scatter_add(p, full, v1, v2)
    assert _rel(got, old) <= TOL
    # per-cone values without a batch dimension broadcast as before
    got1 = genpow._scatter_add(p, full, v1[0], v2[0])
    old1 = genpow._scatter_add(p, full, v1[:1].expand(B, -1, -1),
                               v2[:1].expand(B, -1, -1))
    assert torch.equal(got1, old1)


def test_rectification_means_match_index_add():
    layout = _soc_layouts(api)
    seg, nrect = batch._rect_plan(layout)
    assert nrect == len(SOC_DIMS)
    B = 5
    e = torch.tensor(np.random.default_rng(2).uniform(0.5, 2.0,
                                                      (B, layout.m)))
    valid = np.flatnonzero(seg >= 0)
    old = e.new_zeros(B, nrect).index_add_(
        1, torch.as_tensor(seg[valid]), e[:, torch.as_tensor(valid)])
    segs = segsum.Segments(seg, "cpu")
    got = segsum.segment_sum(e, segs)
    assert _rel(got, old) <= TOL
    assert torch.equal(got, _ascending(e, segs))


def _tiny_batch():
    from cuclarabel_torch.problems import portfolio_socp

    A, qs, bs, cones = portfolio_socp(4, 3, seed=7)
    return ct.BatchSolver(None, qs, A, bs, cones, device="cpu",
                          kkt_solve_method="lu").solve()


def test_op_trace_finds_what_differs():
    """Two traced solves record the same operations with the same hashes
    (the CPU repeats); a planted difference is found at its position."""
    traces = []
    _tiny_batch()  # fills the caches, as solve_digest.repeat does
    for _ in range(2):
        with solve_digest.OpTrace() as tr:
            _tiny_batch()
        traces.append(tr)
    diffs, counts = solve_digest.first_differences(traces)
    assert diffs == [] and counts[0] == counts[1] > 100
    traces[1].hashes[7] = traces[1].hashes[7] + 1
    diffs, _ = solve_digest.first_differences(traces)
    assert [d[0] for d in diffs] == [7]
    assert diffs[0][1] == traces[0].names[7]
