"""Problem generators: one module per family, named by a configuration's
"generator" key.  Each module has

    structure(cfg) -> {"n", "m", "A" (m, n), "P" (n, n) or None,
                       "cones": [(kind, dim), ...]}
    batch(cfg, struct, rng, B) -> {"q" (B, n), "b" (B, m)}

in plain NumPy, vectorised over the batch.  Cone kinds: "zero",
"nonneg", "soc" (dim entries) and "psd" (dim = the matrix side, svec
storage: the upper triangle column by column, off-diagonal entries
times sqrt(2)).
"""

import numpy as np

WINDOW, WARMUP, SAMPLE = 0, 1, 2


def rng(seed, stream, index):
    """The generator of batch `index` of `stream` for `seed` (any whole
    number, negative ones included): WINDOW, the window's batches;
    WARMUP, set-up's batch; SAMPLE, the draw of answers that the
    reference solves again."""
    return np.random.default_rng(
        np.random.SeedSequence([stream, seed % (1 << 64), index]))


def svec_index(d):
    """(rows, cols, scale) of each svec entry of a (d, d) matrix."""
    rows, cols = [], []
    for j in range(d):
        for i in range(j + 1):
            rows.append(i)
            cols.append(j)
    rows, cols = np.array(rows), np.array(cols)
    scale = np.where(rows == cols, 1.0, np.sqrt(2.0))
    return rows, cols, scale


def svec(M):
    """svec of (..., d, d) symmetric matrices -> (..., d(d+1)/2)."""
    rows, cols, scale = svec_index(M.shape[-1])
    return M[..., rows, cols] * scale


def smat(v, d):
    """(..., d(d+1)/2) svecs -> (..., d, d) symmetric matrices."""
    rows, cols, scale = svec_index(d)
    M = np.zeros(v.shape[:-1] + (d, d), dtype=v.dtype)
    vals = v / scale.astype(v.dtype)
    M[..., rows, cols] = vals
    M[..., cols, rows] = vals
    return M
