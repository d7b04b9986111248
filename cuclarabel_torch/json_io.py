"""JSON problem I/O, schema-compatible with the reference
(`src/json.jl:25-209`): un-equilibrated problem data + sanitized
settings, with 0-based CSC indices.

A copy of `cuclarabel_tpu/json_io.py` (the JAX package is the
reference; the port imports nothing from it); its relative imports
resolve to the port's own `cones.api` and `settings`.

A file written by the reference's `save_to_file` loads here and vice
versa (settings fields unknown to the other side are ignored on load).
"""

import json
import math
from typing import Optional

import numpy as np

from .cones import api
from .settings import Settings

_FLOATMAX = float(np.finfo(np.float64).max)


def _dense_to_csc(M: np.ndarray):
    """0-based CSC dict of the nonzeros of a dense matrix
    (lower(::SparseMatrixCSC), json.jl:129-138)."""
    m, n = M.shape
    colptr = [0]
    rowval = []
    nzval = []
    for j in range(n):
        rows = np.nonzero(M[:, j])[0]
        rowval.extend(int(r) for r in rows)
        nzval.extend(float(M[r, j]) for r in rows)
        colptr.append(len(rowval))
    return {"m": m, "n": n, "colptr": colptr, "rowval": rowval, "nzval": nzval}


def _csc_to_dense(d) -> np.ndarray:
    m, n = int(d["m"]), int(d["n"])
    M = np.zeros((m, n))
    colptr = d["colptr"]
    rowval = d["rowval"]
    nzval = d["nzval"]
    for j in range(n):
        for k in range(int(colptr[j]), int(colptr[j + 1])):
            M[int(rowval[k]), j] = float(nzval[k])
    return M


def _lower_cone(cone):
    """Cone -> single-key dict (lower(::SupportedCone), json.jl:140-155);
    field-name parity with the Julia marker types."""
    if isinstance(cone, api.PowerConeT):
        return {"PowerConeT": cone.alpha}
    if isinstance(cone, api.ExponentialConeT):
        return {"ExponentialConeT": []}
    if isinstance(cone, api.GenPowerConeT):
        return {"GenPowerConeT": [list(cone.alpha), cone.dim2]}
    return {type(cone).__name__: cone.dim}


def _parse_cone(d):
    (key, val), = d.items()
    if key == "ExponentialConeT":
        return api.ExponentialConeT()
    if key == "PowerConeT":
        return api.PowerConeT(float(val))
    if key == "GenPowerConeT":
        return api.GenPowerConeT([float(a) for a in val[0]], int(val[1]))
    ctor = getattr(api, key)
    return ctor(int(val))


def _sanitize_settings(s: Settings) -> dict:
    """inf -> floatmax for JSON (sanitize_settings!, json.jl:92-99)."""
    out = {}
    for k, v in s.__dict__.items():
        if isinstance(v, float) and math.isinf(v):
            v = math.copysign(_FLOATMAX, v)
        out[k] = v
    return out


def _desanitize_settings(d: dict) -> Settings:
    valid = set(Settings().__dict__)
    kw = {}
    for k, v in d.items():
        if k not in valid:
            continue  # settings from other implementations: ignore
        if isinstance(v, float) and abs(v) == _FLOATMAX:
            v = math.copysign(math.inf, v)
        kw[k] = v
    return Settings.from_dict(kw)


def save_problem(settings, P, q, A, b, cones, path: str) -> None:
    doc = {
        "settings": _sanitize_settings(settings),
        "P": _dense_to_csc(np.triu(np.asarray(P))),
        "q": [float(v) for v in q],
        "A": _dense_to_csc(np.asarray(A)),
        "b": [float(v) for v in b],
        "cones": [_lower_cone(c) for c in cones],
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def load_problem(path: str, settings: Optional[Settings] = None):
    with open(path) as f:
        doc = json.load(f)
    P = _csc_to_dense(doc["P"])
    q = np.asarray(doc["q"], dtype=np.float64)
    A = _csc_to_dense(doc["A"])
    b = np.asarray(doc["b"], dtype=np.float64)
    cones = [_parse_cone(c) for c in doc["cones"]]
    if settings is None:
        settings = _desanitize_settings(doc.get("settings", {}))
    return P, q, A, b, cones, settings
