"""Layered truncated-list EMS decoding with compressed CtoV storage.

The state is a dense APP [F, N + 1, q] and, per edge, the check-to-variable
message as its nm best (value, GF id) pairs and a saturation level; APP,
values and levels are stored in the configuration's dtype (bfloat16),
rounded to nearest even once where written.  Per super-layer and active
frame:

* the stored message expands to dense costs (a scatter-min of the list,
  capped at the level), and mvc = APP[cols] - CtoV[edges], less its min;
* truncation to the nm best: with a budget (nbOper > 0), values rounded to
  bfloat16 and (bits << 8 | id) sorted as one integer key; without, a
  stable float sort;
* the ids rotate by the row coefficient (multiplication over the GF(2)
  basis); each merge of two lists keeps the nm cheapest distinct GF sums,
  from the staircase {(i + 1)(j + 1) <= nbOper} of candidates, on
  bfloat16-rounded packed keys (GF-major to drop the dearer duplicates,
  then value-major), or from all pairs in float32 without a budget; the
  forward / backward chains give each slot its extrinsic list;
* ids rotate back, the list is normalised to min 0, its level is the last
  filled value plus the offset, and the unfilled tail is capped there;
* CtoV[edges] = the list, APP[cols] = mvc + its dense form.

The control (``control=True``) rounds every stored value to float8
(e5m2) first: the storage one step below bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from . import layered

INF = 1e9
BIG = 1e9
DUP = 0x7FFFFFFF


def _sort(x):
    return torch.sort(x, dim=-1, stable=True).values


def _bf16_bits(x):
    b = torch.clamp_max(x, BIG).to(torch.bfloat16).view(torch.int16)
    return b.to(torch.int32) & 0xFFFF


def _from_bf16_bits(bits):
    return bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)


def basis_cols(gf, coefs: np.ndarray, inverse: bool = False) -> np.ndarray:
    """[*coefs.shape, logq] int32: column b is h * 2^b (or h^-1 * 2^b);
    all zero for h = 0."""
    h = np.asarray(coefs).reshape(-1).astype(np.int64)
    if inverse:
        hi = np.zeros_like(h)
        hi[h != 0] = gf.inv(h[h != 0])
        h = hi
    cols = gf.mul_table[h[:, None], (1 << np.arange(gf.m))[None, :]]
    return cols.reshape(*np.shape(coefs), gf.m).astype(np.int32)


def rotate_ids(g, cols):
    out = torch.zeros_like(g)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for b in range(cols.shape[-1]):
        bit = ((g >> b) & 1) != 0
        out = out ^ torch.where(bit, cols[..., b:b + 1].to(g.dtype), zero)
    return out


def scatter_min(bv, bg, q: int, fill: float = INF):
    out = torch.full(bv.shape[:-1] + (q,), fill, dtype=bv.dtype,
                     device=bv.device)
    return out.scatter_reduce_(-1, bg.long(), bv, reduce="amin")


def best_sorted(v, nm: int):
    vals, ids = torch.sort(v, dim=-1, stable=True)
    return vals[..., :nm], ids[..., :nm]


def best_keys(dense, nm: int):
    q = dense.shape[-1]
    ids = torch.arange(q, dtype=torch.int32, device=dense.device)
    key = _sort((_bf16_bits(dense) << 8) | ids)[..., :nm]
    return _from_bf16_bits((key >> 8) & 0xFFFF), key & 0xFF


def neutral(shape, nm: int, dtype=torch.float32, device=None):
    v = torch.full(tuple(shape) + (nm,), BIG, dtype=dtype, device=device)
    v[..., 0] = 0.0
    g = torch.arange(nm, dtype=torch.int32, device=device)
    return v, g.expand(tuple(shape) + (nm,))


def merge(av, ag, bv, bg, nm: int, nboper: int):
    na, nb = av.shape[-1], bv.shape[-1]
    batch = av.shape[:-1]
    if nboper <= 0:
        cand_v = (av[..., :, None] + bv[..., None, :]).reshape(*batch, na * nb)
        cand_g = (ag[..., :, None] ^ bg[..., None, :]).reshape(*batch, na * nb)
        cand_v = torch.clamp_max(cand_v, BIG)
        cand_g = cand_g.to(torch.int32)
        order = torch.sort(cand_v, dim=-1, stable=True).indices
        cand_g = torch.gather(cand_g, -1, order)
        cand_v = torch.gather(cand_v, -1, order)
        g_l, g_order = torch.sort(cand_g, dim=-1, stable=True)
        v_l = torch.gather(cand_v, -1, g_order)
        first = torch.ones_like(g_l, dtype=torch.bool)
        first[..., 1:] = g_l[..., 1:] != g_l[..., :-1]
        v_l = torch.where(first, v_l, torch.full_like(v_l, BIG))
        v_w, order = torch.sort(v_l, dim=-1, stable=True)
        g_w = torch.gather(g_l, -1, order)
        if v_w.shape[-1] < nm:
            pad = nm - v_w.shape[-1]
            _, pad_g = neutral(batch, pad, v_w.dtype, v_w.device)
            v_w = torch.cat([v_w, torch.full(batch + (pad,), BIG,
                                             dtype=v_w.dtype,
                                             device=v_w.device)], dim=-1)
            g_w = torch.cat([g_w, pad_g], dim=-1)
        return v_w[..., :nm], g_w[..., :nm]
    w = min(nboper, na * nb)
    pieces_v, pieces_g = [], []
    for i in range(na):
        wi = min(nb, w // (i + 1))
        if wi == 0:
            break
        pieces_v.append(av[..., i:i + 1] + bv[..., :wi])
        pieces_g.append(ag[..., i:i + 1] ^ bg[..., :wi])
    vbits = _bf16_bits(torch.cat(pieces_v, dim=-1))
    g32 = torch.cat(pieces_g, dim=-1).to(torch.int32)
    k1 = _sort((g32 << 16) | vbits)
    gpart = k1 >> 16
    first = torch.ones_like(gpart, dtype=torch.bool)
    first[..., 1:] = gpart[..., 1:] != gpart[..., :-1]
    k2 = ((k1 & 0xFFFF) << 8) | gpart
    k2 = torch.where(first, k2, torch.full_like(k2, DUP))
    if k2.shape[-1] < nm:
        k2 = torch.nn.functional.pad(k2, (0, nm - k2.shape[-1]), value=DUP)
    k2 = _sort(k2)[..., :nm]
    dup = k2 == DUP
    ids = torch.arange(nm, dtype=torch.int32, device=k2.device)
    g_w = torch.where(dup, ids, k2 & 0xFF)
    v_w = _from_bf16_bits((k2 >> 8) & 0xFFFF).to(av.dtype)
    v_w = torch.where(dup, torch.full_like(v_w, BIG), v_w)
    return v_w, g_w


def checknode(bv, bg, nm: int, nboper: int):
    """Forward / backward chains over [..., dc, nm] rotated lists."""
    dc = bv.shape[-2]
    if dc == 1:
        nv, ng = neutral(bv.shape[:-2], nm, bv.dtype, bv.device)
        return nv[..., None, :], ng[..., None, :]
    if dc == 2:
        return bv.flip(-2), bg.flip(-2)
    fwd_v, fwd_g = [bv[..., 0, :]], [bg[..., 0, :]]
    bwd_v, bwd_g = [bv[..., dc - 1, :]], [bg[..., dc - 1, :]]
    for i in range(1, dc - 1):
        j = dc - 1 - i
        nv, ng = merge(torch.stack([fwd_v[-1], bwd_v[-1]], dim=-2),
                       torch.stack([fwd_g[-1], bwd_g[-1]], dim=-2),
                       torch.stack([bv[..., i, :], bv[..., j, :]], dim=-2),
                       torch.stack([bg[..., i, :], bg[..., j, :]], dim=-2),
                       nm, nboper)
        fwd_v.append(nv[..., 0, :])
        fwd_g.append(ng[..., 0, :])
        bwd_v.append(nv[..., 1, :])
        bwd_g.append(ng[..., 1, :])
    bwd_v, bwd_g = bwd_v[::-1], bwd_g[::-1]
    mv, mg = merge(torch.stack(fwd_v[:dc - 2], dim=-2),
                   torch.stack(fwd_g[:dc - 2], dim=-2),
                   torch.stack(bwd_v[1:dc - 1], dim=-2),
                   torch.stack(bwd_g[1:dc - 1], dim=-2), nm, nboper)
    out_v = [bwd_v[0]] + [mv[..., i, :] for i in range(dc - 2)] + [fwd_v[-1]]
    out_g = [bwd_g[0]] + [mg[..., i, :] for i in range(dc - 2)] + [fwd_g[-1]]
    return torch.stack(out_v, dim=-2), torch.stack(out_g, dim=-2)


def saturate(ov, offset: float):
    ov = ov - ov[..., 0:1]
    filled = ov < BIG / 2
    last = torch.where(filled, ov, torch.zeros_like(ov)).max(dim=-1).values
    sat = last + offset
    return torch.minimum(ov, sat[..., None]), sat


def expand(ov, og, sat, q: int, dtype):
    dense = torch.minimum(scatter_min(ov, og, q), sat[..., None])
    return dense.to(dtype)


def decode(code, intr: torch.Tensor, dec: dict, control: bool = False,
           block: int = 64):
    """Decode ``intr`` [F, N, q] float32 under the configuration's decoder
    settings ``dec``; returns (decisions, iterations, converged)."""
    if dec["storage"] != "compressed" or dec["cn"] != "ems":
        raise ValueError(f"the list reference decodes compressed EMS: {dec}")
    dev, q, n = intr.device, code.q, code.n
    nm, nboper, offset = dec["nm"], dec["nboper"], dec["offset"]
    dtype = getattr(torch, dec["dtype"])

    def store(x):
        if control:
            x = x.to(torch.float8_e5m2)
        return x.to(dtype)

    truncate = best_keys if nboper > 0 else best_sorted
    plans = []
    for rows in code.layers:
        coefs = code.row_coefs[rows]
        valid = coefs > 0
        plans.append(dict(
            cols=torch.as_tensor(code.row_cols[rows], device=dev),
            edges=torch.as_tensor(code.row_edges[rows], device=dev),
            rc_in=torch.as_tensor(basis_cols(code.gf, coefs), device=dev),
            rc_out=torch.as_tensor(basis_cols(code.gf, coefs, True),
                                   device=dev),
            valid=None if valid.all() else torch.as_tensor(valid, device=dev)))

    def one(x):
        f, e = x.shape[0], code.n_edges
        app = torch.zeros((f, n + 1, q), dtype=dtype, device=dev)
        app[:, :n] = store(x)
        cv_v = torch.zeros((f, e + 1, nm), dtype=dtype, device=dev)
        cv_g = torch.arange(nm, dtype=torch.uint8, device=dev).repeat(
            f, e + 1, 1)
        cv_sat = torch.zeros((f, e + 1), dtype=dtype, device=dev)

        def sweep(active):
            keep = ~active[:, None, None]
            for p in plans:
                cols, edges = p["cols"], p["edges"]
                app_rows = app[:, cols]
                cvv_rows, cvg_rows = cv_v[:, edges], cv_g[:, edges]
                sat_rows = cv_sat[:, edges]
                ctov_rows = expand(cvv_rows.float(), cvg_rows,
                                   sat_rows.float(), q, dtype)
                mvc = app_rows - ctov_rows
                mvc = mvc - mvc.min(dim=-1, keepdim=True).values
                bv, bg = truncate(mvc.float(), nm)
                bgr = rotate_ids(bg.to(torch.int32), p["rc_in"][None])
                if p["valid"] is not None:
                    nv, ng = neutral(bv.shape[:-1], nm, device=dev)
                    lane = p["valid"][None, ..., None]
                    bv = torch.where(lane, bv, nv)
                    bgr = torch.where(lane, bgr, ng)
                ov, ogr = checknode(bv, bgr, nm, nboper)
                og = rotate_ids(ogr, p["rc_out"][None])
                ov, sat = saturate(ov, offset)
                dense = expand(ov, og, sat, q, dtype)
                cv_v[:, edges] = torch.where(keep[..., None], cvv_rows,
                                             store(ov))
                cv_g[:, edges] = torch.where(keep[..., None], cvg_rows,
                                             og.to(torch.uint8))
                cv_sat[:, edges] = torch.where(keep, sat_rows, store(sat))
                app[:, cols] = torch.where(keep[..., None], app_rows,
                                           store(mvc + dense))

        return layered.decode(code, app, sweep, dec["max_iters"])

    return layered.in_blocks(one, intr, block)
