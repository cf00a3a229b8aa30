"""Golden NumPy model of the reference's layered bubble-check EMS decoder.

NumPy copy of ``ems_nbldpc_tpu/golden.py`` (importing any module of the
JAX package loads jax), over the port's own ``models/code.py`` and
``gf.py``.  A from-scratch, readable re-implementation of the *algorithm*
of the C reference's ``NB_LDPC.c:313-472`` + ``bubble_decoder.c``
(layered schedule, nm-truncated sorted messages, 8-bubble elementary check
with an nbOper budget, offset-saturated dense expansion), used as the
behavioral oracle of the bubble check node (``ops/bubble_cn.py``, K9) and
beside the C++ core (``native.py``).  Works in the polynomial
representation (GF add = XOR); the reference's ADDGF table is the same
operation through its power-rep tables.

Deliberately slow and simple: correctness is its only job.
"""
from __future__ import annotations

import numpy as np

from .models.code import NBCode

BIG = 1e5  # reference "infinity" (bubble_decoder.c:107,371)


def sort_truncate(dense: np.ndarray, nm: int):
    """Dense [q] cost -> (vals [<=nm] ascending, gfs), min-normalized.

    Mirrors NB_LDPC.c:354-374 (selection sort + normalization). Ties broken
    by symbol index like the C selection sort (strict '<' keeps the first).
    """
    order = np.argsort(dense, kind="stable")[:nm]
    vals = dense[order].astype(np.float64)
    vals -= vals[0]
    return vals, order.astype(np.int64)


def elementary_bubble(v1, g1, v2, g2, nm: int, nb_oper: int,
                      nb_bubble: int = 8):
    """The 8-bubble ElementaryStep (bubble_decoder.c:316-593), exact.

    Inputs are sorted (vals ascending, poly-rep GF ids). Entries with gf < 0
    are "unfilled" (the C code's -1 indices). Returns (vals, gfs) of length
    nm with unfilled tail marked gf = -1, val = BIG.
    """
    n1, n2 = len(v1), len(v2)
    half = nb_bubble // 2
    out_v = np.full(nm, BIG)
    out_g = np.full(nm, -1, dtype=np.int64)
    seen = set()
    # bubble state: value, i (row into input1), j (col into input2), moves
    # rows 0..half-1 start at column 0 and move right; the other half start
    # at row `half`, columns 0..half-1, and move down.
    bubbles = []
    for r in range(half):
        bubbles.append([v1[r] + v2[0] if r < n1 else BIG, r, 0, "right"])
    for c in range(half):
        bubbles.append(
            [v1[half] + v2[c] if half < n1 and c < n2 else BIG, half, c, "down"]
        )
    s = 0
    for _ in range(nb_oper):
        pos = min(range(nb_bubble), key=lambda t: bubbles[t][0])
        val, i, j, mv = bubbles[pos]
        if i >= n1 or j >= n2 or g1[i] < 0 or g2[j] < 0:
            break
        gf = int(g1[i]) ^ int(g2[j])
        if gf not in seen:
            out_v[s] = val
            out_g[s] = gf
            seen.add(gf)
            s += 1
        if s == nm:
            break
        # boundary rule (bubble_decoder.c:506-544): stop the whole loop if
        # this bubble cannot advance
        if i >= nm - 1 or j >= nm - 1:
            break
        if mv == "down":
            i += 1
        else:
            j += 1
        nv = v1[i] + v2[j] if (i < n1 and j < n2) else BIG
        bubbles[pos] = [nv, i, j, mv]
    return out_v, out_g


def elementary_lbubble(v1, g1, v2, g2, nm: int, nb_oper: int):
    """The v2 standalone decoder's 4-candidate "L-bubble" operator
    (EMS_HS_L-BubbleCheck_UBS_decoder_v2.c:1547-1701), min-convention.

    Seeds: column-0 rows 0..2 plus (row 2, col 1); bubbles 0,1 move right
    along rows 0 and 1; bubbles 2,3 move down columns 0 and 1 (the "2 rows
    + 2 columns" L shape; the update rule ``u = pos>>1; row += u;
    col += 1-u`` at v2:1678-1684).
    """
    n1, n2 = len(v1), len(v2)
    out_v = np.full(nm, BIG)
    out_g = np.full(nm, -1, dtype=np.int64)
    seen = set()

    def cand(i, j):
        if i >= n1 or j >= n2 or g1[i] < 0 or g2[j] < 0:
            return BIG
        return v1[i] + v2[j]

    # [value, i, j, moves_down]
    bubbles = [
        [cand(0, 0), 0, 0, False],
        [cand(1, 0), 1, 0, False],
        [cand(2, 0), 2, 0, True],
        [cand(2, 1), 2, 1, True],
    ]
    s = 0
    for _ in range(nb_oper):
        pos = min(range(4), key=lambda t: bubbles[t][0])
        val, i, j, down = bubbles[pos]
        if i >= n1 or j >= n2 or g1[i] < 0 or g2[j] < 0:
            break
        gf = int(g1[i]) ^ int(g2[j])
        if gf not in seen:
            out_v[s] = val
            out_g[s] = gf
            seen.add(gf)
            s += 1
        if s == nm:
            break
        if i >= nm - 1 or j >= nm - 1:
            break
        if down:
            i += 1
        else:
            j += 1
        bubbles[pos] = [cand(i, j), i, j, down]
    return out_v, out_g


def check_pass_ems(vals, gfs, coefs, gf_mul, gf_div, nm, nb_oper, offset, q,
                   bubble="8"):
    """F/B bubble-check CN for one row (bubble_decoder.c:72-305).

    vals/gfs: [dc][nm] sorted truncated VtoC messages (poly rep).
    coefs: [dc] poly-rep row coefficients.
    Returns dense [dc, q] CtoV messages (offset-saturated expansion).
    """
    dc = len(coefs)
    elem = elementary_bubble if bubble == "8" else elementary_lbubble
    # rotate in: gf -> h * gf
    rgfs = [gf_mul[coefs[t]][gfs[t]] for t in range(dc)]
    fwd_v = [None] * dc
    fwd_g = [None] * dc
    bwd_v = [None] * dc
    bwd_g = [None] * dc
    fwd_v[0], fwd_g[0] = vals[0], rgfs[0]
    bwd_v[dc - 1], bwd_g[dc - 1] = vals[dc - 1], rgfs[dc - 1]
    for t in range(1, dc - 1):
        fwd_v[t], fwd_g[t] = elem(
            fwd_v[t - 1], fwd_g[t - 1], vals[t], rgfs[t], nm, nb_oper
        )
        u = dc - 1 - t
        bwd_v[u], bwd_g[u] = elem(
            bwd_v[u + 1], bwd_g[u + 1], vals[u], rgfs[u], nm, nb_oper
        )
    out = np.zeros((dc, q))
    for t in range(dc):
        if t == 0:
            ov, og = bwd_v[1], bwd_g[1]
        elif t == dc - 1:
            ov, og = fwd_v[dc - 2], fwd_g[dc - 2]
        else:
            ov, og = elem(
                fwd_v[t - 1], fwd_g[t - 1], bwd_v[t + 1], bwd_g[t + 1],
                nm, nb_oper
            )
        filled = og >= 0
        stp = int(filled.sum())
        if stp == 0:
            out[t] = offset
            continue
        # un-rotate + dense expansion with saturation (bubble_decoder.c:249-278)
        sat = ov[stp - 1] + offset
        dense = np.full(q, sat)
        dense[gf_div[og[:stp]][:, coefs[t]]] = ov[:stp]
        out[t] = dense
    return out


def decode_layered_golden(
    code: NBCode, intrinsic: np.ndarray, max_iters: int, nm: int,
    offset: float, nb_oper: int, bubble: str = "8",
):
    """One-frame layered EMS decode. intrinsic: [N, q] min-cost dense.

    Returns (decide [N], n_iters, converged).
    """
    gf = code.gf
    q = code.q
    mul = gf.mul_table
    app = intrinsic.astype(np.float64).copy()
    ctov = np.zeros((code.n_edges, q))
    offs = np.concatenate([[0], np.cumsum(code.row_deg)])
    decide = app.argmin(axis=1)

    def synd_ok(d):
        s = np.zeros(code.m_rows, dtype=np.int64)
        prod = mul[code.edge_coef, d[code.edge_col]]
        np.bitwise_xor.at(s, code.edge_row, prod)
        return not np.any(s)

    if synd_ok(decide):
        return decide, 0, True
    for it in range(max_iters):
        for r in range(code.m_rows):
            d = int(code.row_deg[r])
            cols = code.row_cols[r, :d]
            edges = np.arange(offs[r], offs[r] + d)
            coefs = code.row_coefs[r, :d]
            vals, gfs = [], []
            for t in range(d):
                mvc = app[cols[t]] - ctov[edges[t]]
                v, s = sort_truncate(mvc, nm)
                vals.append(v)
                gfs.append(s)
            mcv = check_pass_ems(
                vals, gfs, coefs, mul, _div_table(gf), nm, nb_oper, offset,
                q, bubble=bubble,
            )
            for t in range(d):
                mvc = app[cols[t]] - ctov[edges[t]]
                ctov[edges[t]] = mcv[t]
                app[cols[t]] = mcv[t] + mvc
        decide = app.argmin(axis=1)
        if synd_ok(decide):
            return decide, it + 1, True
    return decide, max_iters, False


_div_cache = {}


def _div_table(gf):
    """div[a, h] = a * h^{-1} (h > 0)."""
    if gf.q not in _div_cache:
        q = gf.q
        t = np.zeros((q, q), dtype=np.int64)
        hs = np.arange(1, q)
        t[:, 1:] = gf.mul_table[:, gf.inv(hs)]
        _div_cache[gf.q] = t
    return _div_cache[gf.q]
