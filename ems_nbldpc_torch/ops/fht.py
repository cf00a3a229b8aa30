"""Sum-product check node via the Walsh-Hadamard transform, in plain torch.

Port of ``ems_nbldpc_tpu/ops/fht.py``.  Over GF(2^m) the check-node
convolution over the XOR group diagonalizes under the Walsh-Hadamard
transform (WHT), so the exact sum-product CN is

    out_i  =  IWHT( prod_{j != i} WHT(P_j) ) / q

with the partial products taken by a forward/backward sweep.  The GF
rotation by a row coefficient h is linear over GF(2)^m, so it folds into
the transform as a permutation ``t_h`` of the transform domain
(``mul_transpose_perm``):

    in:   w[u] = WHT(p)[t_h[u]]
    out:  y[t_h[u]] = x[u]  (a gather with t_h^-1), then WHT(y) / q

The JAX package contracted against row-permuted Hadamard matrices, one
matmul per coefficient group; here one matmul against the plain Hadamard
matrix plus per-position gather tables does it for every coefficient.
A padding lane (h = 0, ``t_0 = 0``) comes out as the JAX package's H_0
gives it: in the transform domain it is the neutral ``w = sum(p) = 1``,
and its output is all-equal probabilities, i.e. costs of 0.

The hand-written CUDA version is ``ops/cuda_spa.spa_checknode``.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

_LOG_EPS = 60.0  # cost clamp: exp(-60) ~ 1e-26 keeps the WHT well-conditioned
_P_FLOOR = float(np.float32(np.exp(-_LOG_EPS)))


@functools.lru_cache(maxsize=None)
def hadamard(q: int) -> np.ndarray:
    """[q, q] Walsh-Hadamard matrix H[u, v] = (-1)^popcount(u & v)."""
    u = np.arange(q)
    pc = np.vectorize(lambda x: bin(x).count("1"))(u[:, None] & u[None, :])
    return np.where(pc % 2 == 0, 1.0, -1.0).astype(np.float32)


def costs_to_probs(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost messages -> normalized probabilities."""
    c = cost - cost.min(dim=-1, keepdim=True).values
    p = torch.exp(-torch.clamp_max(c, _LOG_EPS))
    return p / p.sum(dim=-1, keepdim=True)


def probs_to_costs(p: torch.Tensor) -> torch.Tensor:
    c = -torch.log(torch.clamp_min(p, _P_FLOOR))
    return c - c.min(dim=-1, keepdim=True).values


def _fb_products(w: torch.Tensor) -> torch.Tensor:
    """Extrinsic forward/backward products along the dc axis (transform
    domain): out[..., i, :] = prod_{j != i} w[..., j, :]."""
    dc = w.shape[-2]
    if dc == 1:
        return torch.ones_like(w)
    if dc == 2:
        return w.flip(-2)
    fwd = [w[..., 0, :]]
    bwd = [w[..., dc - 1, :]]
    for i in range(1, dc - 1):
        fwd.append(fwd[-1] * w[..., i, :])
        bwd.append(bwd[-1] * w[..., dc - 1 - i, :])
    bwd = bwd[::-1]
    outs = [bwd[0]]
    for i in range(1, dc - 1):
        outs.append(fwd[i - 1] * bwd[i])
    outs.append(fwd[-1])
    return torch.stack(outs, dim=-2)


def mul_transpose_perm(gf, h: int) -> np.ndarray:
    """Index map t with t[u] = M_h^T u, where M_h is the GF(2)-bit-matrix
    of multiplication by h (column b = bits of h * 2^b).

    Folds GF rotations into the Hadamard transform:
    WHT(x rotated by h)[u] = WHT(x)[t[u]]  (rotation is linear over
    GF(2)^m, and the WHT character pairing transposes it)."""
    q = gf.q
    if h == 0:
        return np.zeros(q, np.int64)
    u = np.arange(q)
    t = np.zeros(q, np.int64)
    for b in range(gf.m):
        col = int(gf.mul(h, 1 << b))
        par = u & col                       # parity of popcount(u & col)
        for s in (4, 2, 1):                 # folds up to 8-bit values
            par = par ^ (par >> s)
        t |= (par & 1).astype(np.int64) << b
    return t


@functools.lru_cache(maxsize=None)
def transpose_perm_tables(gf) -> tuple[np.ndarray, np.ndarray]:
    """([q, q] t, [q, q] t^-1) as uint8: row h is ``mul_transpose_perm(gf,
    h)`` and its inverse permutation.  Row 0 (padding) is all zeros in t
    and the identity in t^-1; no reader uses the latter."""
    t = np.stack([mul_transpose_perm(gf, h) for h in range(gf.q)])
    tinv = np.empty_like(t)
    tinv[0] = np.arange(gf.q)
    tinv[1:] = np.argsort(t[1:], axis=-1)
    return t.astype(np.uint8), tinv.astype(np.uint8)


def position_tables(coefs: torch.Tensor, t_tab: torch.Tensor,
                    tinv_tab: torch.Tensor):
    """Per-position int64 gather tables (t_in, t_out), each
    ``[*coefs.shape, q]``, from a code's ``transpose_perm_tables``."""
    c = coefs.long()
    return t_tab[c].long(), tinv_tab[c].long()


@contextlib.contextmanager
def _fp32_matmul():
    """Full-f32 matrix products: TF32 keeps ~3 decimal digits, and the
    inverse WHT cancels q terms of O(1) down to probabilities of 1e-26
    (a reduced-precision WHT stopped the full-size code converging)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def spa_checknode_plain(mvc: torch.Tensor, t_in: torch.Tensor,
                        t_out: torch.Tensor) -> torch.Tensor:
    """SPA check node with the GF rotations folded into the WHT.

    mvc: [..., G, dc, q] UN-rotated min-cost VtoC messages (f32);
    t_in, t_out: [G, dc, q] int64 tables from ``position_tables``.
    Returns [..., G, dc, q] UN-rotated min-cost CtoV messages (min 0).
    Equivalent to the JAX package's ``fb_checknode_spa_fused``.  The two
    products run in full f32 with TF32 off (``_fp32_matmul``).
    """
    q = mvc.shape[-1]
    h = torch.as_tensor(hadamard(q), device=mvc.device)
    pad = (t_in == 0).all(dim=-1)                      # h = 0 lanes: t_0 = 0
    p = costs_to_probs(mvc)
    with _fp32_matmul():
        w = torch.gather(p @ h, -1, t_in.expand(mvc.shape))  # WHT, permute
        y = torch.gather(_fb_products(w), -1, t_out.expand(mvc.shape))
        out_p = (y @ h) / q                            # IWHT (H symmetric)
    out_p = torch.clamp_min(out_p, 1e-30)
    costs = probs_to_costs(out_p)
    return costs.masked_fill(pad[..., None], 0.0)
