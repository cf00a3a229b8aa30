"""The code graph the reference decodes on, from the raw matrix.

Rows are grouped into super-layers (no two rows of a group share a
column) by the colouring that the layered schedule is defined with: the
better of a balanced greedy colouring and DSATUR with repair, fewest
layers first, then the most balanced.  A layered decoder's trajectory
depends on this grouping, so it is worked out here again from the rows.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from .gf import Field, field


def _balanced_greedy(row_cols: list) -> list:
    groups: list[list[int]] = []
    gcols: list[set] = []
    for r, cols in enumerate(row_cols):
        cols = set(cols.tolist())
        cand = [i for i in range(len(groups)) if not (gcols[i] & cols)]
        if cand:
            gi = min(cand, key=lambda i: len(groups[i]))
            groups[gi].append(r)
            gcols[gi] |= cols
        else:
            groups.append([r])
            gcols.append(set(cols))
    return [np.array(g, np.int64) for g in groups]


def _dsatur(row_cols: list) -> list:
    m = len(row_cols)
    rcols = [set(c.tolist()) for c in row_cols]
    colrows = defaultdict(list)
    for r in range(m):
        for c in rcols[r]:
            colrows[c].append(r)
    adj: list[set] = [set() for _ in range(m)]
    for rs in colrows.values():
        for a in rs:
            adj[a].update(rs)
    for r in range(m):
        adj[r].discard(r)
    deg = [len(a) for a in adj]
    colors = np.full(m, -1, np.int64)
    sat: list[set] = [set() for _ in range(m)]
    order = sorted(range(m), key=lambda r: -deg[r])
    for _ in range(m):
        r = max((x for x in order if colors[x] < 0),
                key=lambda x: (len(sat[x]), deg[x]))
        c = 0
        while c in sat[r]:
            c += 1
        colors[r] = c
        for b in adj[r]:
            sat[b].add(c)
    groups = [list(np.flatnonzero(colors == c))
              for c in range(int(colors.max()) + 1)]
    gcols = [set().union(*(rcols[r] for r in g)) for g in groups]

    def fits(r, gi):
        return not (rcols[r] & gcols[gi])

    # dissolve the smallest group where every one of its rows moves
    improved = True
    while improved and len(groups) > 1:
        improved = False
        gi = min(range(len(groups)), key=lambda i: len(groups[i]))
        moves = []
        for r in groups[gi]:
            tgt = next((j for j in range(len(groups))
                        if j != gi and fits(r, j)), None)
            if tgt is None:
                break
            moves.append((r, tgt))
            gcols[tgt] |= rcols[r]
        else:
            for r, tgt in moves:
                groups[tgt].append(r)
            del groups[gi], gcols[gi]
            improved = True
        if not improved:
            gcols = [set().union(*(rcols[r] for r in g)) for g in groups]
    # balance: move rows from the largest group into the smallest
    for _ in range(m):
        big = max(range(len(groups)), key=lambda i: len(groups[i]))
        small = min(range(len(groups)), key=lambda i: len(groups[i]))
        if len(groups[big]) - len(groups[small]) <= 1:
            break
        r = next((r for r in groups[big] if fits(r, small)), None)
        if r is None:
            break
        groups[big].remove(r)
        groups[small].append(r)
        gcols[small] |= rcols[r]
        gcols[big] = set().union(*(rcols[x] for x in groups[big]))
    return [np.sort(np.array(g, np.int64)) for g in groups]


def color_rows(row_cols: list) -> list:
    """Column-disjoint row groups, in the order the layered sweep visits
    them."""
    a, b = _balanced_greedy(row_cols), _dsatur(row_cols)

    def score(layers):
        sizes = [len(g) for g in layers]
        return len(layers), max(sizes) - min(sizes)

    return a if score(a) <= score(b) else b


@dataclasses.dataclass(eq=False)
class Code:
    """Padded row arrays ([M, dc], padding: column n, coefficient 0, edge
    E), edges numbered row by row, and the super-layers."""
    n: int
    m: int
    q: int
    row_cols: np.ndarray
    row_coefs: np.ndarray
    row_edges: np.ndarray
    layers: list

    @property
    def k(self) -> int:
        return self.n - self.m

    @property
    def n_edges(self) -> int:
        return int((self.row_coefs > 0).sum())

    @property
    def gf(self) -> Field:
        return field(self.q)

    def syndrome_ok(self, decide: torch.Tensor) -> torch.Tensor:
        """[F, N] symbols -> [F] bool: every check satisfied."""
        dev = decide.device
        mul = torch.as_tensor(self.gf.mul_table, device=dev)
        cols = torch.as_tensor(self.row_cols, device=dev)
        coefs = torch.as_tensor(self.row_coefs, device=dev)
        sym = torch.nn.functional.pad(decide.long(), (0, 1))[:, cols]
        u = mul[coefs, sym]                               # [F, M, dc]
        synd = u[..., 0]
        for j in range(1, u.shape[-1]):
            synd = synd ^ u[..., j]
        return (synd == 0).all(dim=-1)


def build(row_cols: list, row_coefs: list, n: int, q: int) -> Code:
    """``row_cols`` / ``row_coefs``: one array per row (coefficients in
    polynomial representation, non-zero)."""
    m = len(row_cols)
    deg = np.array([len(c) for c in row_cols])
    dc = int(deg.max())
    cols = np.full((m, dc), n, np.int64)
    coefs = np.zeros((m, dc), np.int64)
    edges = np.full((m, dc), int(deg.sum()), np.int64)
    offs = np.concatenate([[0], np.cumsum(deg)])
    for r in range(m):
        cols[r, :deg[r]] = row_cols[r]
        coefs[r, :deg[r]] = row_coefs[r]
        edges[r, :deg[r]] = np.arange(offs[r], offs[r + 1])
    if np.any(coefs[cols < n] == 0):
        raise ValueError("a coefficient of the matrix is 0")
    return Code(n, m, q, cols, coefs, edges, color_rows(row_cols))
