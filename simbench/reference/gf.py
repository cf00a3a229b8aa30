"""GF(2^m) tables in polynomial representation (addition is XOR)."""
from __future__ import annotations

import functools

import numpy as np

# the primitive polynomials of the simulated fields
PRIM_POLY = {4: 0b111, 8: 0b1011, 16: 0b10011, 32: 0b100101,
             64: 0b1000011, 128: 0b10000011, 256: 0b100011101}


class Field:
    """exp / log tables and the [q, q] multiplication table of GF(q)."""

    def __init__(self, q: int):
        if q not in PRIM_POLY:
            raise ValueError(f"unsupported field order {q}")
        self.q, self.m = q, q.bit_length() - 1
        exp = np.zeros(q - 1, np.int64)
        v = 1
        for i in range(q - 1):
            exp[i] = v
            v <<= 1
            if v & q:
                v ^= PRIM_POLY[q]
        log = np.full(q, -1, np.int64)
        log[exp] = np.arange(q - 1)
        self.exp, self.log = exp, log
        a = np.arange(q)
        self.mul_table = self.mul(a[:, None], a[None, :])

    def mul(self, a, b) -> np.ndarray:
        a, b = np.broadcast_arrays(np.asarray(a, np.int64),
                                   np.asarray(b, np.int64))
        out = np.zeros(a.shape, np.int64)
        nz = (a != 0) & (b != 0)
        out[nz] = self.exp[(self.log[a[nz]] + self.log[b[nz]]) % (self.q - 1)]
        return out

    def inv(self, a) -> np.ndarray:
        a = np.asarray(a, np.int64)
        if np.any(a == 0):
            raise ZeroDivisionError("inverse of 0 in GF")
        return self.exp[(-self.log[a]) % (self.q - 1)]


@functools.lru_cache(maxsize=None)
def field(q: int) -> Field:
    return Field(q)
