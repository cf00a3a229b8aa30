"""Layered sum-product decoding over GF(q) through the Walsh-Hadamard
transform, in float32 (the transform's products with TF32 off).

Per super-layer and active frame: mvc = APP[cols] - CtoV[edges], less its
minimum; the check node turns costs into probabilities p = exp(-c) / sum,
rotates each input by its coefficient h and convolves over the XOR group,
which the WHT diagonalises, so out_i = IWHT(prod_{j != i} WHT(P_j)) / q.
Multiplication by h is linear over GF(2)^m, so the rotation folds into
the transform domain as the permutation t_h[u] = M_h^T u.  Costs come
back as -log(max(p, exp(-60))), less their minimum; then CtoV[edges] = mcv
and APP[cols] = mvc + mcv.  The control (``control=True``) rounds both
products' operands to TF32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import layered
from .channel import round_tf32

LOG_EPS = 60.0
P_FLOOR = float(np.float32(np.exp(-LOG_EPS)))


def hadamard(q: int) -> np.ndarray:
    u = np.arange(q)
    pc = np.vectorize(lambda x: bin(x).count("1"))(u[:, None] & u[None, :])
    return np.where(pc % 2 == 0, 1.0, -1.0).astype(np.float32)


def transform_perm(gf, h: int) -> np.ndarray:
    """t with WHT(x rotated by h)[u] = WHT(x)[t[u]]; all 0 for h = 0."""
    q = gf.q
    if h == 0:
        return np.zeros(q, np.int64)
    u = np.arange(q)
    t = np.zeros(q, np.int64)
    for b in range(gf.m):
        col = int(gf.mul(h, 1 << b))
        par = u & col
        for s in (4, 2, 1):
            par = par ^ (par >> s)
        t |= (par & 1).astype(np.int64) << b
    return t


def _products(w: torch.Tensor) -> torch.Tensor:
    """out[..., i, :] = prod_{j != i} w[..., j, :] (forward / backward)."""
    dc = w.shape[-2]
    if dc == 1:
        return torch.ones_like(w)
    if dc == 2:
        return w.flip(-2)
    fwd, bwd = [w[..., 0, :]], [w[..., dc - 1, :]]
    for i in range(1, dc - 1):
        fwd.append(fwd[-1] * w[..., i, :])
        bwd.append(bwd[-1] * w[..., dc - 1 - i, :])
    bwd = bwd[::-1]
    outs = [bwd[0]] + [fwd[i - 1] * bwd[i] for i in range(1, dc - 1)]
    return torch.stack(outs + [fwd[-1]], dim=-2)


def _matmul(a, b, control):
    if control:
        a = round_tf32(a)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def checknode(mvc, t_in, t_out, pad, had, control=False):
    q = mvc.shape[-1]
    c = mvc - mvc.min(dim=-1, keepdim=True).values
    p = torch.exp(-torch.clamp_max(c, LOG_EPS))
    p = p / p.sum(dim=-1, keepdim=True)
    w = torch.gather(_matmul(p, had, control), -1, t_in.expand(mvc.shape))
    y = torch.gather(_products(w), -1, t_out.expand(mvc.shape))
    out_p = torch.clamp_min(_matmul(y, had, control) / q, 1e-30)
    cost = -torch.log(torch.clamp_min(out_p, P_FLOOR))
    cost = cost - cost.min(dim=-1, keepdim=True).values
    return cost.masked_fill(pad[..., None], 0.0)


def _plans(code, device):
    gf, q = code.gf, code.q
    t = np.stack([transform_perm(gf, h) for h in range(q)])
    tinv = np.empty_like(t)
    tinv[0] = np.arange(q)
    tinv[1:] = np.argsort(t[1:], axis=-1)
    plans = []
    for rows in code.layers:
        coefs = code.row_coefs[rows]
        plans.append(dict(
            cols=torch.as_tensor(code.row_cols[rows], device=device),
            edges=torch.as_tensor(code.row_edges[rows], device=device),
            t_in=torch.as_tensor(t[coefs], device=device),
            t_out=torch.as_tensor(tinv[coefs], device=device),
            pad=torch.as_tensor(coefs == 0, device=device)))
    return plans


def decode(code, intr: torch.Tensor, dec: dict, control: bool = False,
           block: int = 64):
    """Decode ``intr`` [F, N, q] float32 under the configuration's decoder
    settings ``dec``; returns (decisions, iterations, converged)."""
    if dec["cn"] != "spa" or dec["dtype"] != "float32":
        raise ValueError(f"the SPA reference decodes cn=spa at float32: {dec}")
    dev, q = intr.device, code.q
    plans = _plans(code, dev)
    had = torch.as_tensor(hadamard(q), device=dev)

    def one(x):
        f = x.shape[0]
        app = torch.zeros((f, code.n + 1, q), device=dev)
        app[:, :code.n] = x
        ctov = torch.zeros((f, code.n_edges + 1, q), device=dev)

        def sweep(active):
            act = active[:, None, None, None]
            for p in plans:
                app_rows, ctov_rows = app[:, p["cols"]], ctov[:, p["edges"]]
                mvc = app_rows - ctov_rows
                mvc = mvc - mvc.min(dim=-1, keepdim=True).values
                mcv = checknode(mvc, p["t_in"], p["t_out"], p["pad"], had,
                                control)
                ctov[:, p["edges"]] = torch.where(act, mcv, ctov_rows)
                app[:, p["cols"]] = torch.where(act, mvc + mcv, app_rows)

        return layered.decode(code, app, sweep, dec["max_iters"])

    return layered.in_blocks(one, intr, block)
