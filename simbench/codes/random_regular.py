"""A random (dv, dc)-regular code over GF(q).

The configuration model with ``numpy.random.default_rng(seed)``: the
column sockets (each column dv times) shuffled and cut into rows of dc,
redrawn until no row repeats a column, each row's columns sorted; then
dc non-zero coefficients drawn a row, in row order, and paired with the
sorted columns.
"""
from __future__ import annotations

import numpy as np


def make(n: int, m: int, q: int, dv: int, seed: int):
    if (n * dv) % m:
        raise ValueError(f"n * dv = {n * dv} is not a multiple of m = {m}")
    dc = n * dv // m
    rng = np.random.default_rng(seed)
    for _ in range(100):
        sockets = np.repeat(np.arange(n), dv)
        rng.shuffle(sockets)
        rows = np.sort(sockets.reshape(m, dc), axis=1)
        if np.all(rows[:, 1:] != rows[:, :-1]):
            break
    else:
        raise RuntimeError("no simple graph in 100 draws")
    coefs = [rng.integers(1, q, size=dc) for _ in range(m)]
    return list(rows), coefs
