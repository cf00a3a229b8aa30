"""GF(2^m) arithmetic tables in polynomial representation (NumPy, host only).

Copy of ``ems_nbldpc_tpu/gf.py`` (the JAX package cannot be imported
without loading jax).  A field element is an integer in ``[0, q)`` whose
bits are its coordinates over GF(2): addition is XOR, multiplication is a
log/antilog lookup.  The device only ever sees XOR on integers and gathers
through precomputed permutations.

The reference C decoder stores parity-check coefficients in *power
representation* (symbol 0 is zero, symbol ``k >= 1`` is ``alpha^(k-1)``,
``init.c:211-227``); ``power_to_poly`` / ``poly_to_power`` convert.
"""
from __future__ import annotations

import functools

import numpy as np

# Primitive polynomials: the reference's fields (X^4+X+1, X^6+X+1,
# X^8+X^4+X^3+X^2+1) plus the orders it cannot load.
PRIM_POLY = {
    4: 0b111,          # X^2+X+1
    8: 0b1011,         # X^3+X+1
    16: 0b10011,       # X^4+X+1
    32: 0b100101,      # X^5+X^2+1
    64: 0b1000011,     # X^6+X+1
    128: 0b10000011,   # X^7+X+1
    256: 0b100011101,  # X^8+X^4+X^3+X^2+1
}


class GF:
    """Tables for GF(q), q = 2^m, in polynomial representation."""

    def __init__(self, q: int):
        if q not in PRIM_POLY:
            raise ValueError(f"unsupported field order {q}")
        self.q = q
        self.m = q.bit_length() - 1
        self.prim = PRIM_POLY[q]

        # antilog: exp[i] = poly value of alpha^i, i in [0, q-1)
        exp = np.zeros(q - 1, dtype=np.int64)
        v = 1
        for i in range(q - 1):
            exp[i] = v
            v <<= 1
            if v & q:
                v ^= self.prim
        if v != 1:
            raise AssertionError("polynomial is not primitive")
        self.exp = exp
        log = np.full(q, -1, dtype=np.int64)
        log[exp] = np.arange(q - 1)
        self.log = log  # log[0] stays -1 (undefined)

        # power index 0 -> zero, power index k>=1 -> alpha^(k-1)
        self.power_to_poly = np.concatenate([[0], exp]).astype(np.int64)
        p2p = np.zeros(q, dtype=np.int64)
        p2p[self.power_to_poly] = np.arange(q)
        self.poly_to_power = p2p

    def add(self, a, b):
        return np.bitwise_xor(a, b)

    def mul(self, a, b):
        a, b = np.broadcast_arrays(
            np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)
        )
        out = np.zeros(a.shape, dtype=np.int64)
        nz = (a != 0) & (b != 0)
        out[nz] = self.exp[(self.log[a[nz]] + self.log[b[nz]]) % (self.q - 1)]
        return out if out.ndim else out[()]

    def inv(self, a):
        a = np.asarray(a, dtype=np.int64)
        if np.any(a == 0):
            raise ZeroDivisionError("inverse of 0 in GF")
        return self.exp[(-self.log[a]) % (self.q - 1)]

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def pow(self, a, k: int):
        a = np.asarray(a, dtype=np.int64)
        out = np.zeros_like(a)
        nz = a != 0
        out[nz] = self.exp[(self.log[a[nz]] * k) % (self.q - 1)]
        return out

    @functools.cached_property
    def mul_table(self) -> np.ndarray:
        """[q, q] polynomial-rep multiplication table."""
        a = np.arange(self.q)
        return self.mul(a[:, None], a[None, :])

    @functools.cached_property
    def xor_table(self) -> np.ndarray:
        a = np.arange(self.q)
        return a[:, None] ^ a[None, :]

    def mul_perm(self, h) -> np.ndarray:
        """Permutation p with p[s] = h*s (poly rep). Rows of mul_table."""
        h = np.asarray(h, dtype=np.int64)
        return self.mul_table[h]

    def bits(self, a, bit_order: str = "lsb") -> np.ndarray:
        """Binary image of polynomial-rep symbols, shape (..., m).

        ``lsb``: bit i = coefficient of X^i.
        """
        a = np.asarray(a, dtype=np.int64)
        shifts = np.arange(self.m)
        if bit_order == "msb":
            shifts = shifts[::-1]
        return (a[..., None] >> shifts) & 1

    def from_bits(self, bits, bit_order: str = "lsb"):
        bits = np.asarray(bits, dtype=np.int64)
        shifts = np.arange(self.m)
        if bit_order == "msb":
            shifts = shifts[::-1]
        return (bits << shifts).sum(axis=-1)


@functools.lru_cache(maxsize=None)
def get_gf(q: int) -> GF:
    return GF(q)
