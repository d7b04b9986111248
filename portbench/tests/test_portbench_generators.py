"""The generators: deterministic from the seed, a new batch for every
index, and the same problems as the port's own generators."""

import numpy as np
import pytest

from conftest import ROOT
from portbench import generators, harness

CELLS = ("portfolio-n148-pallas-b4096", "maxcut-n90-b4096",
         "portfolio-n292-pallas-b2048")


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_data_other_index_other_data(cell):
    c = harness.Cell(ROOT, cell)
    st = c.generator.structure(c.config)
    seed = 2 ** 31 + 12345
    a = c.generator.batch(c.config, st, generators.rng(seed, 0, 3), 64)
    b = c.generator.batch(c.config, st, generators.rng(seed, 0, 3), 64)
    d = c.generator.batch(c.config, st, generators.rng(seed, 0, 4), 64)
    w = c.generator.batch(c.config, st, generators.rng(seed, 1, 3), 64)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["b"] if "maxcut" in cell else a["q"],
                              d["b"] if "maxcut" in cell else d["q"])
    assert not np.array_equal(a["b"] if "maxcut" in cell else a["q"],
                              w["b"] if "maxcut" in cell else w["q"])
    assert a["q"].shape == (64, st["n"]) and a["b"].shape == (64, st["m"])


def test_negative_and_large_seeds():
    for seed in (-1, 0, 2 ** 31 + 7, 2 ** 40):
        generators.rng(seed, 0, 0).random()


def test_portfolio_is_the_ports_problem():
    from cuclarabel_torch.problems import portfolio_socp
    c = harness.Cell(ROOT, CELLS[0])
    st = c.generator.structure(c.config)
    A, qs, bs, cones = portfolio_socp(64, 2, seed=7)
    assert np.array_equal(st["A"], A)
    assert [(type(k).__name__, k.dim) for k in cones] == [
        ("ZeroConeT", 1), ("NonnegativeConeT", 65),
        ("SecondOrderConeT", 17)]
    assert [d for _, d in st["cones"]] == [1, 65, 17]


def test_maxcut_is_the_ports_problem():
    from cuclarabel_torch.problems import maxcut_sdp, svec
    c = harness.Cell(ROOT, CELLS[1])
    st = c.generator.structure(c.config)
    P, qs, A, bs, cones, Ls = maxcut_sdp(12, 3, seed=0)
    assert np.array_equal(st["A"], A)
    rng = np.random.default_rng(5)
    M = rng.standard_normal((12, 12))
    M = M + M.T
    assert np.allclose(generators.svec(M), svec(M), rtol=0, atol=1e-15)
    assert np.allclose(generators.smat(generators.svec(M), 12), M)
    d = c.generator.batch(c.config, st, generators.rng(1, 0, 0), 8)
    L = -4 * generators.smat(d["b"], 12)
    assert np.allclose(L.sum(axis=2), 0) and np.all(L[:, range(12),
                                                       range(12)] >= 0)
