"""GF(q) encoder: host-side Gaussian elimination + binary generator matrix.

NumPy copy of ``ems_nbldpc_tpu/models/encoder.py``.  The reference encodes
one frame at a time by back-substitution through a dense upper-triangular
matrix (``tools.c:151-268``).  Here the same object is exposed as

* ``Encoder.encode_np``      — vectorized NumPy back-substitution (golden);
* ``Encoder.bit_generator``  — the encoding map as a binary matrix over
  the bit image, ``parity_bits = info_bits @ P mod 2``: GF(2^m)-linear
  maps are GF(2)-linear on binary images, so the device encoder is one
  matrix product (``sim/mc.make_codeword_fn``).

Systematic convention matches the reference: after the column permutation
``perm``, positions ``perm[m_rows:]`` carry the info symbols.

Results are cached on disk under ``NBLDPC_TORCH_CACHE_DIR`` (default
``~/.cache/nbldpc_torch``), apart from the JAX package's cache.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os

import numpy as np

from ..gf import GF
from .code import NBCode, from_jax_code

CACHE_DIR = os.environ.get(
    "NBLDPC_TORCH_CACHE_DIR",
    os.path.join(os.path.expanduser("~"), ".cache", "nbldpc_torch"),
)


def _code_digest(code: NBCode) -> str:
    h = hashlib.sha256()
    for a in (code.row_cols, code.row_coefs, np.int64([code.q, code.n])):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:20]


@dataclasses.dataclass
class Encoder:
    code: NBCode
    mat_ut: np.ndarray   # [M, N] upper-triangular, poly rep, after column perm
    perm: np.ndarray     # [N] column permutation: NSYMB[i] -> CodeWord[perm[i]]

    @property
    def gf(self) -> GF:
        return self.code.gf

    def encode_np(self, info: np.ndarray) -> np.ndarray:
        """info: [..., K] poly-rep symbols -> codeword [..., N]."""
        code, gf = self.code, self.gf
        m, n = code.m_rows, code.n
        info = np.asarray(info, dtype=np.int64)
        nsymb = np.zeros(info.shape[:-1] + (n,), dtype=np.int64)
        nsymb[..., m:] = info
        ut = self.mat_ut
        inv_diag = gf.inv(ut[np.arange(m), np.arange(m)])
        for r in range(m - 1, -1, -1):
            cols = np.nonzero(ut[r, r + 1:])[0] + r + 1
            acc = np.zeros(info.shape[:-1], dtype=np.int64)
            for c in cols:
                acc ^= gf.mul(ut[r, c], nsymb[..., c])
            nsymb[..., r] = gf.mul(acc, inv_diag[r])
        cw = np.zeros_like(nsymb)
        cw[..., self.perm] = nsymb
        return cw

    @functools.cached_property
    def bit_generator(self) -> np.ndarray:
        cache = os.path.join(
            CACHE_DIR, f"bitgen_{_code_digest(self.code)}.npz"
        )
        if os.path.exists(cache):
            return np.load(cache)["p"]
        p = self._build_bit_generator()
        try:
            os.makedirs(CACHE_DIR, exist_ok=True)
            np.savez_compressed(cache + ".tmp.npz", p=p)
            os.replace(cache + ".tmp.npz", cache)
        except OSError:
            pass
        return p

    def _build_bit_generator(self) -> np.ndarray:
        """P: [K*m_bits, M*m_bits] uint8; parity_bits = info_bits @ P mod 2.

        Packed-bit back-substitution: solve U X = B over GF(2) where U, B
        are the binary images of the triangular / info parts of
        ``mat_ut``.  Bit order: symbol-major, LSB-first.
        """
        code, gf = self.code, self.gf
        mr, k, nb = code.m_rows, code.k, code.logq
        kbits = k * nb
        words = (kbits + 63) // 64

        def mulmat_bits(c: int) -> np.ndarray:
            # [nb, nb] binary matrix: out_bits = Mc @ in_bits
            cols = gf.bits(gf.mul(c, 1 << np.arange(nb)))  # [nb(in), nb(out)]
            return cols.T.astype(np.uint8)

        # dep[x]: [nb, words] packed dependence of symbol x's bits on the
        # info bits
        dep = np.zeros((code.n, nb, words), dtype=np.uint64)
        for i in range(k):
            for b in range(nb):
                bit = i * nb + b
                dep[mr + i, b, bit // 64] = np.uint64(1) << np.uint64(bit % 64)
        ut = self.mat_ut
        inv_diag = gf.inv(ut[np.arange(mr), np.arange(mr)])
        for r in range(mr - 1, -1, -1):
            cols = np.nonzero(ut[r, r + 1:])[0] + r + 1
            acc = np.zeros((nb, words), dtype=np.uint64)
            for c in cols:
                mc = mulmat_bits(int(ut[r, c]))
                # acc ^= Mc @ dep[c]  (GF(2) matmul on packed rows)
                for ob in range(nb):
                    row = np.zeros(words, dtype=np.uint64)
                    for ib in range(nb):
                        if mc[ob, ib]:
                            row ^= dep[c, ib]
                    acc[ob] ^= row
            mi = mulmat_bits(int(inv_diag[r]))
            for ob in range(nb):
                row = np.zeros(words, dtype=np.uint64)
                for ib in range(nb):
                    if mi[ob, ib]:
                        row ^= acc[ib]
                dep[r, ob] = row
        pbits = np.zeros((kbits, mr * nb), dtype=np.uint8)
        for r in range(mr):
            for b in range(nb):
                bits = np.unpackbits(
                    dep[r, b].view(np.uint8), bitorder="little"
                )[:kbits]
                pbits[:, r * nb + b] = bits
        return pbits

    def systematic_positions(self) -> np.ndarray:
        """Codeword positions holding the info symbols, in info order."""
        return self.perm[self.code.m_rows:]


def gaussian_elimination(code: NBCode) -> Encoder:
    """Column-pivoted GF(q) elimination to upper-triangular form.

    Vectorized NumPy equivalent of the reference's ``tools.c:151-218``.
    Raises if H is rank-deficient.  Cached on disk (sparse triplets) by
    the code's content digest.
    """
    cache = os.path.join(CACHE_DIR, f"ge_{_code_digest(code)}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        a = np.zeros((code.m_rows, code.n), dtype=np.int64)
        a[z["r"], z["c"]] = z["v"]
        return Encoder(code=code, mat_ut=a, perm=z["perm"])
    enc = _gaussian_elimination_impl(code)
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
        r, c = np.nonzero(enc.mat_ut)
        np.savez_compressed(
            cache + ".tmp.npz", r=r, c=c, v=enc.mat_ut[r, c], perm=enc.perm
        )
        os.replace(cache + ".tmp.npz", cache)
    except OSError:
        pass
    return enc


def _gaussian_elimination_impl(code: NBCode) -> Encoder:
    gf = code.gf
    m, n = code.m_rows, code.n
    a = np.zeros((m, n), dtype=np.int64)
    for r in range(m):
        d = int(code.row_deg[r])
        a[r, code.row_cols[r, :d]] = code.row_coefs[r, :d]
    perm = np.arange(n)
    logt, expt = gf.log, gf.exp
    for r in range(m):
        nz = np.nonzero(a[r, r:])[0]
        if nz.size == 0:
            raise ValueError(f"H is not full rank at row {r}")
        piv = r + int(nz[0])
        if piv != r:
            perm[[r, piv]] = perm[[piv, r]]
            a[:, [r, piv]] = a[:, [piv, r]]
        below = np.nonzero(a[r + 1:, r])[0] + r + 1
        if below.size:
            # factor f = a[i, r] / a[r, r]; row_i = row_i + f * row_r
            pl = logt[a[r, r]]
            fl = (logt[a[below, r]] - pl) % (gf.q - 1)  # log of factors
            seg = a[r, r:]
            nzc = np.nonzero(seg)[0]
            scaled = np.zeros((below.size, seg.size), dtype=np.int64)
            scaled[:, nzc] = expt[(fl[:, None] + logt[seg[nzc]][None, :]) % (gf.q - 1)]
            a[below[:, None], np.arange(r, n)[None, :]] ^= scaled
    return Encoder(code=code, mat_ut=a, perm=perm)


def from_jax_encoder(obj, code: NBCode | None = None) -> Encoder:
    """Rebuild an encoder from any object with the JAX ``Encoder``'s
    ``mat_ut`` and ``perm`` (and ``code``, unless ``code`` is given)."""
    if code is None:
        code = from_jax_code(obj.code)
    return Encoder(code=code, mat_ut=np.asarray(obj.mat_ut, np.int64),
                   perm=np.asarray(obj.perm))


def syndrome_np(code: NBCode, cw: np.ndarray) -> np.ndarray:
    """Batched syndrome weight (0 iff codeword). cw: [..., N] poly rep."""
    gf = code.gf
    cw = np.asarray(cw, dtype=np.int64)
    flat = cw.reshape(-1, code.n)
    sym = flat[:, code.edge_col]
    prod = gf.mul(code.edge_coef[None, :], sym)
    # edge order is row-major, so a segmented XOR per row is a reduceat
    offs = np.concatenate([[0], np.cumsum(code.row_deg)[:-1]])
    synd = np.bitwise_xor.reduceat(prod, offs, axis=1)
    return (synd != 0).sum(axis=-1).reshape(cw.shape[:-1])
