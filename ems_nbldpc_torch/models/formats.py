"""Parity-check matrix file parsers (NumPy copy of the JAX package's).

* **KN** (reference ``init.c:211-227``): header ``N M q``; N column
  degrees; M row degrees; then per row ``rowDegree`` pairs
  ``col(1-based) exponent`` with coefficient ``alpha^exponent``.
* **UBS** (reference ``init.c:195-207``): same header and degree blocks,
  then an M×rowDegree block of 0-based columns and an M×rowDegree block of
  coefficients in power representation (``k`` means ``alpha^(k-1)``).
* **MacKay q-ary alist**: header ``N M q``; ``dvmax dcmax``; degrees; then
  per column ``dvmax`` pairs ``row(1-based) value``, zero-padded.  Values
  are polynomial-representation field elements.

Coefficients come out in polynomial representation.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..gf import get_gf


@dataclasses.dataclass
class ParsedMatrix:
    n: int
    m: int
    q: int
    row_cols: list  # per-row arrays of 0-based column indices
    row_coefs_poly: list  # matching coefficients, polynomial rep

    @property
    def col_degrees(self) -> np.ndarray:
        deg = np.zeros(self.n, dtype=np.int64)
        for cols in self.row_cols:
            np.add.at(deg, cols, 1)
        return deg


def _read_ints(path: str) -> np.ndarray:
    if path.endswith(".gz"):
        import gzip

        with gzip.open(path, "rt") as f:
            txt = f.read()
    else:
        with open(path, "r") as f:
            txt = f.read()
    return np.array(txt.split(), dtype=np.int64)


def _try_parse_ubs(toks, n, m, q, col_deg, row_deg):
    e = int(row_deg.sum())
    if toks.size < 2 * e:
        return None
    cols = toks[: e]
    vals = toks[e: 2 * e]
    if cols.min() < 0 or cols.max() >= n:
        return None
    if vals.min() < 1 or vals.max() >= q:
        return None
    gf = get_gf(q)
    row_cols, row_coefs = [], []
    off = 0
    deg_check = np.zeros(n, dtype=np.int64)
    for r in range(m):
        d = int(row_deg[r])
        c = cols[off: off + d]
        if len(np.unique(c)) != d:
            return None
        np.add.at(deg_check, c, 1)
        row_cols.append(c.copy())
        row_coefs.append(gf.power_to_poly[vals[off: off + d]])
        off += d
    if not np.array_equal(deg_check, col_deg):
        return None
    return row_cols, row_coefs


def _try_parse_kn(toks, n, m, q, col_deg, row_deg):
    e = int(row_deg.sum())
    if toks.size < 2 * e:
        return None
    pairs = toks[: 2 * e].reshape(e, 2)
    cols1 = pairs[:, 0]
    exps = pairs[:, 1]
    if cols1.min() < 1 or cols1.max() > n:
        return None
    if exps.min() < 0 or exps.max() >= q - 1:
        return None
    gf = get_gf(q)
    row_cols, row_coefs = [], []
    off = 0
    deg_check = np.zeros(n, dtype=np.int64)
    for r in range(m):
        d = int(row_deg[r])
        c = cols1[off: off + d] - 1
        if len(np.unique(c)) != d:
            return None
        np.add.at(deg_check, c, 1)
        row_cols.append(c)
        row_coefs.append(gf.exp[exps[off: off + d] % (q - 1)].copy())
        off += d
    if not np.array_equal(deg_check, col_deg):
        return None
    return row_cols, row_coefs


def parse_knubs(path: str, fmt: str = "auto") -> ParsedMatrix:
    """Parse a KN- or UBS-format file (header ``N M q``)."""
    toks = _read_ints(path)
    n, m, q = int(toks[0]), int(toks[1]), int(toks[2])
    col_deg = toks[3: 3 + n]
    row_deg = toks[3 + n: 3 + n + m]
    body = toks[3 + n + m:]

    candidates = {}
    if fmt in ("auto", "ubs"):
        r = _try_parse_ubs(body, n, m, q, col_deg, row_deg)
        if r:
            candidates["ubs"] = r
    if fmt in ("auto", "kn"):
        r = _try_parse_kn(body, n, m, q, col_deg, row_deg)
        if r:
            candidates["kn"] = r
    if not candidates:
        raise ValueError(f"{path}: not parseable as KN or UBS")
    if len(candidates) == 2:
        # ambiguous: KN files in the wild live under a KN/ directory
        pick = "kn" if "KN" in os.path.abspath(path) else "ubs"
    else:
        (pick,) = candidates
    row_cols, row_coefs = candidates[pick]
    return ParsedMatrix(n, m, q, row_cols, row_coefs)


def parse_alist(path: str) -> ParsedMatrix:
    """MacKay q-ary (or binary) alist, column-major entries."""
    toks = _read_ints(path)
    n, m = int(toks[0]), int(toks[1])
    pos = 2
    # q-ary alist has a third header int = q (a power of two >= 4); a
    # binary alist goes straight to "dvmax dcmax"
    q = int(toks[2])
    if q >= 4 and (q & (q - 1)) == 0 and toks.size > 5:
        pos = 3
    else:
        q = 2
    dvmax, _dcmax = int(toks[pos]), int(toks[pos + 1])
    pos += 2
    pos += n  # column degrees
    row_deg = toks[pos: pos + m]
    pos += m
    per = 2 if q > 2 else 1
    row_cols = [[] for _ in range(m)]
    row_coefs = [[] for _ in range(m)]
    for col in range(n):
        block = toks[pos: pos + dvmax * per]
        pos += dvmax * per
        if q > 2:
            rows = block[0::2]
            vals = block[1::2]
        else:
            rows = block
            vals = np.ones_like(block)
        for r, v in zip(rows, vals):
            if r == 0:
                continue
            row_cols[int(r) - 1].append(col)
            row_coefs[int(r) - 1].append(int(v))
    row_cols = [np.array(c, dtype=np.int64) for c in row_cols]
    row_coefs = [np.array(v, dtype=np.int64) for v in row_coefs]
    if not all(len(c) == int(d) for c, d in zip(row_cols, row_deg)):
        raise ValueError(f"{path}: alist row degrees inconsistent")
    return ParsedMatrix(n, m, q, row_cols, row_coefs)


def parse(path: str, fmt: str = "auto") -> ParsedMatrix:
    if fmt == "alist":
        return parse_alist(path)
    if fmt in ("kn", "ubs"):
        return parse_knubs(path, fmt)
    # auto: try KN/UBS first, fall back to alist
    try:
        return parse_knubs(path, "auto")
    except Exception:
        return parse_alist(path)
