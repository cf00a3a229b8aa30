"""Offline matrix tooling: NumPy copy of ``ems_nbldpc_tpu/models/tools.py``
(the Python equivalent of the reference's MATLAB converters
``alist2sparse.m``, ``alist2sparse2.m``, ``sparse2alist.m``): conversions
between alist files, (rows, cols, values) triplets, and the KN/UBS text
formats, writing the same bytes as the JAX package's.
"""
from __future__ import annotations

import numpy as np

from .formats import ParsedMatrix, parse


def to_coo(parsed: ParsedMatrix):
    """(rows, cols, vals) triplet arrays (vals in poly rep)."""
    rows = np.repeat(
        np.arange(parsed.m), [len(c) for c in parsed.row_cols]
    )
    cols = np.concatenate(parsed.row_cols)
    vals = np.concatenate(parsed.row_coefs_poly)
    return rows, cols, vals


def to_dense(parsed: ParsedMatrix) -> np.ndarray:
    """[M, N] dense H with poly-rep coefficients (alist2sparse.m analog)."""
    h = np.zeros((parsed.m, parsed.n), dtype=np.int64)
    r, c, v = to_coo(parsed)
    h[r, c] = v
    return h


def from_dense(h: np.ndarray, q: int) -> ParsedMatrix:
    m, n = h.shape
    row_cols, row_coefs = [], []
    for r in range(m):
        c = np.nonzero(h[r])[0]
        row_cols.append(c)
        row_coefs.append(h[r, c])
    return ParsedMatrix(n, m, q, row_cols, row_coefs)


def write_alist(parsed: ParsedMatrix, path: str):
    """q-ary alist writer (sparse2alist.m analog), column-major entries."""
    h = to_dense(parsed)
    m, n = parsed.m, parsed.n
    col_deg = (h != 0).sum(axis=0)
    row_deg = (h != 0).sum(axis=1)
    dvmax, dcmax = int(col_deg.max()), int(row_deg.max())
    with open(path, "w") as f:
        f.write(f"{n} {m} {parsed.q}\n{dvmax} {dcmax}\n")
        f.write(" ".join(map(str, col_deg)) + " \n")
        f.write(" ".join(map(str, row_deg)) + " \n")
        for c in range(n):
            rows = np.nonzero(h[:, c])[0]
            ent = [f"{r + 1} {h[r, c]}" for r in rows]
            ent += ["0 0"] * (dvmax - len(rows))
            f.write(" \t".join(ent) + " \t\n")
        for r in range(m):
            cols = np.nonzero(h[r])[0]
            ent = [f"{c + 1} {h[r, c]}" for c in cols]
            ent += ["0 0"] * (dcmax - len(cols))
            f.write(" \t".join(ent) + " \t\n")


def write_ubs(parsed: ParsedMatrix, path: str):
    """UBS text format writer (the reference's native format,
    init.c:195-207): header, degree blocks, column-index block, power-rep
    value block."""
    from ..gf import get_gf

    gf = get_gf(parsed.q)
    with open(path, "w") as f:
        f.write(f"{parsed.n} {parsed.m} {parsed.q}\n\n")
        f.write(" ".join(map(str, parsed.col_degrees)) + " \n\n")
        f.write(" ".join(str(len(c)) for c in parsed.row_cols) + " \n\n")
        for c in parsed.row_cols:
            f.write(" ".join(map(str, c)) + " \n")
        f.write("\n")
        for v in parsed.row_coefs_poly:
            f.write(" ".join(map(str, gf.poly_to_power[v])) + " \n")


def convert(src: str, dst: str, fmt: str = "auto"):
    """File-to-file conversion; output format chosen by dst extension
    (.alist -> alist, anything else -> UBS)."""
    parsed = parse(src, fmt)
    if dst.endswith(".alist"):
        write_alist(parsed, dst)
    else:
        write_ubs(parsed, dst)
    return parsed
