"""The systematic encoder's information set, and the codeword check.

Column-pivoted elimination of H over GF(q) to upper-triangular form (the
first non-zero column at or right of the diagonal is swapped in) gives
the column permutation ``perm``: the columns ``perm[:m]`` of H are full
rank, so a codeword is fixed by its symbols at ``perm[m:]``, which carry
the frame's information symbols in order.  A codeword of the right frame
is therefore one that satisfies every check and carries those symbols
there; nothing else does.
"""
from __future__ import annotations

import numpy as np
import torch

from .code import Code


def information_set(code: Code) -> np.ndarray:
    """``perm``: the codeword positions of the information symbols are
    ``perm[code.m:]``.  Raises if H is rank-deficient."""
    gf = code.gf
    m, n, qm1 = code.m, code.n, code.q - 1
    a = np.zeros((m, n), np.int64)
    for r in range(m):
        live = code.row_cols[r] < n
        a[r, code.row_cols[r, live]] = code.row_coefs[r, live]
    perm = np.arange(n)
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
            fl = (gf.log[a[below, r]] - gf.log[a[r, r]]) % qm1
            seg = a[r, r:]
            nzc = np.nonzero(seg)[0]
            scaled = np.zeros((below.size, seg.size), np.int64)
            scaled[:, nzc] = gf.exp[(fl[:, None] + gf.log[seg[nzc]][None, :])
                                    % qm1]
            a[below[:, None], np.arange(r, n)[None, :]] ^= scaled
    return perm


def info_symbols(info_bits: torch.Tensor, k: int, logq: int) -> torch.Tensor:
    """[F, k * logq] 0/1 bits (symbol-major, least significant bit first)
    -> [F, k] symbols."""
    shifts = torch.arange(logq, device=info_bits.device)
    bits = info_bits.to(torch.int64).reshape(info_bits.shape[0], k, logq)
    return (bits << shifts).sum(-1)


def wrong_codewords(code: Code, perm: np.ndarray, cw: torch.Tensor,
                    info: torch.Tensor) -> torch.Tensor:
    """[F] bool: frame f's ``cw`` fails a check or does not carry
    ``info[f]`` on the information set."""
    pos = torch.as_tensor(perm[code.m:], device=cw.device)
    carries = (cw[:, pos] == info).all(dim=1)
    return ~(carries & code.syndrome_ok(cw))
