"""Truncated-list EMS check node: sorted (value, GF id) lists end to end.

Port of ``ems_nbldpc_tpu/ops/listcn.py``.  The reference approximates each
2-input merge of its nm-truncated F/B check node with a sequential bubble
loop bounded by nbOper candidate examinations with GF dedup
(``bubble_decoder.c:72-593``).  Here a merge is a data-parallel
selection: build the candidate sums and XORs, sort them, drop every
candidate whose GF id an earlier (cheaper) one already holds, keep the
best nm.  With a budget, candidates come from the static staircase
{(i+1)(j+1) <= nbOper}, which holds every candidate an nbOper-bounded
extract-min loop could examine.

Packed keys.  A non-negative bf16's bit pattern orders like its value, so
a (value, GF id) pair sorts as ONE int32 key.  torch has no bitcast to an
unsigned 16-bit type: ``x.to(bfloat16).view(int16)`` gives the same bits
(values are clamped to ``BIG`` and never negative, so the sign bit is 0).
f32 -> bf16 rounds to nearest-even in both frameworks.  Every key is
unique per message except the ``0x7FFFFFFF`` dup marker, so the sort order
is fully determined; the sorts are stable all the same.

Only the chain form of the F/B recursion is carried: the tree form
measured 11.5x slower on the TPU and has the same meaning only up to
where truncations happen.
"""
from __future__ import annotations

import numpy as np
import torch

from .minconv import INF, scatter_topk_dense, topk_message

# value of deduplicated / unfilled slots; sorts after every real cost but
# stays far from f32/bf16 saturation when offsets are added
BIG = 1e9
_DUP = 0x7FFFFFFF


def _sort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True).values


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern of ``min(x, BIG)`` rounded to bf16 (x >= 0)."""
    b = torch.clamp_max(x, BIG).to(torch.bfloat16).view(torch.int16)
    return b.to(torch.int32) & 0xFFFF


def _from_bf16_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 value of the bf16 whose bit pattern is ``bits`` (int32)."""
    return bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)


def mul_cols(gf, coefs: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Per-position GF(2)-basis columns of multiplication by ``coefs``.

    Returns int32 [*coefs.shape, logq] with ``out[..., b] = h * alpha_b``
    (or ``h^-1 * alpha_b``), where alpha_b = 2^b in the polynomial basis.
    ``h = 0`` (padding) yields all-zero columns (maps everything to 0);
    padding lanes must be masked to the neutral list by the caller anyway.
    """
    coefs = np.asarray(coefs)
    logq = int(np.log2(gf.q))
    h = coefs.reshape(-1).astype(np.int64)
    if inverse:
        hi = np.zeros_like(h)
        nz = h != 0
        hi[nz] = gf.inv(h[nz])
        h = hi
    basis = 1 << np.arange(logq)
    cols = gf.mul_table[h[:, None], basis[None, :]]
    return cols.reshape(*coefs.shape, logq).astype(np.int32)


def rotate_ids(g: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """XOR-fold rotation of GF id tensors: out = h * g elementwise.

    g: [..., nm] int; cols: [..., logq] int32 broadcastable against g's
    batch dims (typically [G, dc, logq] vs [F, G, dc, nm]).
    """
    out = torch.zeros_like(g)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for b in range(cols.shape[-1]):
        bit = ((g >> b) & 1) != 0
        out = out ^ torch.where(bit, cols[..., b:b + 1].to(g.dtype), zero)
    return out


def topk_list(dense: torch.Tensor, nm: int):
    """Best-nm (ascending values, GF ids) of a dense non-negative message.

    Packed-key sort: values quantize to bf16 and ``(bits << 8) | id``
    sorts as one int32 key; the nm smallest keys are the list.  Returns
    (f32 values, int32 ids).
    """
    q = dense.shape[-1]
    ids = torch.arange(q, dtype=torch.int32, device=dense.device)
    key = _sort((_bf16_bits(dense) << 8) | ids)[..., :nm]
    return _from_bf16_bits((key >> 8) & 0xFFFF), key & 0xFF


def neutral_list(shape, nm: int, dtype=torch.float32, device=None):
    """Identity of the list merge: cost 0 at GF 0, unfilled elsewhere.

    GF ids of the unfilled tail are distinct (iota) so dedup never
    collapses real entries against padding.
    """
    v = torch.full(tuple(shape) + (nm,), BIG, dtype=dtype, device=device)
    v[..., 0] = 0.0
    g = torch.arange(nm, dtype=torch.int32, device=device)
    return v, g.expand(tuple(shape) + (nm,))


def list_combine(av: torch.Tensor, ag: torch.Tensor, bv: torch.Tensor,
                 bg: torch.Tensor, nm: int, nboper: int = 0):
    """Merge two sorted truncated messages: best-nm distinct-GF sums.

    av/bv: [..., na]/[..., nb] ascending costs (BIG = unfilled); ag/bg:
    matching GF ids (int32).  Returns (ov [..., nm] ascending, og [..., nm]
    int32); unfilled slots carry cost >= BIG.

    nboper <= 0: exact top-nm-distinct over all na*nb candidates, in f32.
    nboper > 0: candidates restricted to the staircase {(i+1)(j+1) <=
    nboper}, values quantized to bf16 and packed into int32 keys.
    """
    na, nb = av.shape[-1], bv.shape[-1]
    batch = av.shape[:-1]
    if nboper <= 0:
        cand_v = (av[..., :, None] + bv[..., None, :]).reshape(*batch, na * nb)
        cand_g = (ag[..., :, None] ^ bg[..., None, :]).reshape(*batch, na * nb)
        cand_v = torch.clamp_max(cand_v, BIG)
        cand_g = cand_g.to(torch.int32)
        # dedup: order by (GF, value) -- stable sorts by value, then by GF;
        # the first entry of each GF run is its minimum, the rest go to BIG
        v_order = torch.sort(cand_v, dim=-1, stable=True).indices
        cand_g = torch.gather(cand_g, -1, v_order)
        cand_v = torch.gather(cand_v, -1, v_order)
        g_l, g_order = torch.sort(cand_g, dim=-1, stable=True)
        v_l = torch.gather(cand_v, -1, g_order)
        first = torch.ones_like(g_l, dtype=torch.bool)
        first[..., 1:] = g_l[..., 1:] != g_l[..., :-1]
        v_l = torch.where(first, v_l, torch.full_like(v_l, BIG))
        v_w, order = torch.sort(v_l, dim=-1, stable=True)
        g_w = torch.gather(g_l, -1, order)
        if v_w.shape[-1] < nm:
            pad = nm - v_w.shape[-1]
            _, pad_g = neutral_list(batch, pad, v_w.dtype, v_w.device)
            v_w = torch.cat([v_w, torch.full(batch + (pad,), BIG,
                                             dtype=v_w.dtype,
                                             device=v_w.device)], dim=-1)
            g_w = torch.cat([g_w, pad_g], dim=-1)
        return v_w[..., :nm], g_w[..., :nm]

    # budgeted: staircase support, static slices (216 candidates at
    # nm = 32, nbOper = 64)
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
    # key1: GF major, value minor -> GF runs sorted by value
    k1 = _sort((g32 << 16) | vbits)
    gpart = k1 >> 16
    first = torch.ones_like(gpart, dtype=torch.bool)
    first[..., 1:] = gpart[..., 1:] != gpart[..., :-1]
    # key2: value major, GF minor (both recoverable); dups -> marker key
    k2 = ((k1 & 0xFFFF) << 8) | gpart
    k2 = torch.where(first, k2, torch.full_like(k2, _DUP))
    width = k2.shape[-1]
    if width < nm:
        k2 = torch.nn.functional.pad(k2, (0, nm - width), value=_DUP)
    k2 = _sort(k2)[..., :nm]
    dup = k2 == _DUP
    ids = torch.arange(nm, dtype=torch.int32, device=k2.device)
    g_w = torch.where(dup, ids, k2 & 0xFF)
    v_w = _from_bf16_bits((k2 >> 8) & 0xFFFF).to(av.dtype)
    v_w = torch.where(dup, torch.full_like(v_w, BIG), v_w)
    return v_w, g_w


def fb_checknode_list(bv: torch.Tensor, bg: torch.Tensor, nm: int,
                      nboper: int = 0):
    """Forward/backward CN over truncated lists (EMS semantics).

    bv/bg: [..., dc, nm] sorted rotated input lists.  Returns (ov, og):
    [..., dc, nm] truncated extrinsic outputs per slot, the op structure of
    ``CheckPassLogEMS`` (``bubble_decoder.c:97,166-227``): 2(dc-2) chain
    merges + (dc-2) middle merges, with the forward and backward chains
    batched into one merge per step and all middles in one merge.
    """
    dc = bv.shape[-2]
    if dc == 1:
        nv, ng = neutral_list(bv.shape[:-2], nm, bv.dtype, bv.device)
        return nv[..., None, :], ng[..., None, :]
    if dc == 2:
        return bv.flip(-2), bg.flip(-2)
    fwd_v, fwd_g = [bv[..., 0, :]], [bg[..., 0, :]]
    bwd_v, bwd_g = [bv[..., dc - 1, :]], [bg[..., dc - 1, :]]
    for i in range(1, dc - 1):
        j = dc - 1 - i
        acc_v = torch.stack([fwd_v[-1], bwd_v[-1]], dim=-2)
        acc_g = torch.stack([fwd_g[-1], bwd_g[-1]], dim=-2)
        in_v = torch.stack([bv[..., i, :], bv[..., j, :]], dim=-2)
        in_g = torch.stack([bg[..., i, :], bg[..., j, :]], dim=-2)
        nv, ng = list_combine(acc_v, acc_g, in_v, in_g, nm, nboper)
        fwd_v.append(nv[..., 0, :])
        fwd_g.append(ng[..., 0, :])
        bwd_v.append(nv[..., 1, :])
        bwd_g.append(ng[..., 1, :])
    bwd_v = bwd_v[::-1]
    bwd_g = bwd_g[::-1]  # bwd[i] = merge of slots i+1..dc-1
    mv, mg = list_combine(
        torch.stack(fwd_v[:dc - 2], dim=-2), torch.stack(fwd_g[:dc - 2], dim=-2),
        torch.stack(bwd_v[1:dc - 1], dim=-2), torch.stack(bwd_g[1:dc - 1], dim=-2),
        nm, nboper)
    out_v = [bwd_v[0]] + [mv[..., i, :] for i in range(dc - 2)] + [fwd_v[-1]]
    out_g = [bwd_g[0]] + [mg[..., i, :] for i in range(dc - 2)] + [fwd_g[-1]]
    return torch.stack(out_v, dim=-2), torch.stack(out_g, dim=-2)


def saturate_list(ov: torch.Tensor, offset: float):
    """(normalized ov, sat): the reference's output handling
    (``bubble_decoder.c:262-278``).

    Normalizes min to 0, computes sat = (last *filled* value) + offset and
    clamps unfilled tail slots to sat.  ov must be ascending.
    """
    ov = ov - ov[..., 0:1]
    filled = ov < BIG / 2
    last = torch.where(filled, ov, torch.zeros_like(ov)).max(dim=-1).values
    sat = last + offset
    return torch.minimum(ov, sat[..., None]), sat


def expand_list(ov, og, sat, q: int, dtype=None):
    """Truncated (ov, og, sat) -> dense [..., q] message (scatter-min)."""
    dense = scatter_topk_dense(ov, og, q, fill=INF)
    dense = torch.minimum(dense, sat[..., None])
    return dense if dtype is None else dense.to(dtype)


def list_layer_plain(app, cv_v, cv_g, cv_sat, active, cols, edges, rc_in,
                     rc_out, valid, nm: int, nboper: int,
                     offset: float) -> None:
    """One layered truncated-list EMS super-layer, in place: the plain
    torch step that ``ops/cuda_list.list_layer`` (K3) fuses, and, on CPU
    tensors only, the route of ``nboper = 0`` and of shapes outside K3's
    limits.

    app: [F, N+1, q] dense APP; cv_v [F, E+1, nm], cv_g [F, E+1, nm]
    uint8, cv_sat [F, E+1]: the compressed CtoV (the reference's nm sorted
    entries + saturated fill, bubble_decoder.c:262-278), app, cv_v and
    cv_sat of one dtype; active: [F] bool (False: converged, written back
    as read); cols, edges: the layer's [G, dc] APP columns and CtoV edges
    (int32 or int64; padded slots at column N and edge E); rc_in, rc_out:
    [G, dc, logq] int32 GF(2)-basis columns (``mul_cols``) of h and h^-1;
    valid: [G, dc] bool (False at padded slots) or None.  nboper > 0:
    packed-key truncation (bf16 keys) and staircase merges; nboper = 0:
    the exact f32 sorts.  Padded slots compute on the padding column and
    edge and scatter there (several slots, one element).
    """
    q = app.shape[-1]
    # packed-key truncation quantizes to bf16 (the storage dtype); the
    # exact (nboper = 0) mode keeps the f32 sort for bit-exact oracle tests
    truncate = topk_list if nboper > 0 else topk_message
    edge_ids, cols = edges.long(), cols.long()
    keep = ~active[:, None, None]                        # [F, 1, 1]
    app_rows = app[:, cols]                              # [F, G, dc, q]
    cvv_rows = cv_v[:, edge_ids]
    cvg_rows = cv_g[:, edge_ids]
    sat_rows = cv_sat[:, edge_ids]
    ctov_rows = expand_list(
        cvv_rows.float(), cvg_rows, sat_rows.float(), q, app.dtype)
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    # VN truncation (NB_LDPC.c:354-374) + rotation of the id lists
    bv, bg = truncate(mvc.float(), nm)
    bgr = rotate_ids(bg.to(torch.int32), rc_in[None])
    if valid is not None:
        nv, ng = neutral_list(bv.shape[:-1], nm, device=bv.device)
        lane = valid[None, ..., None]
        bv = torch.where(lane, bv, nv)
        bgr = torch.where(lane, bgr, ng)
    ov, ogr = fb_checknode_list(bv, bgr, nm, nboper)
    og = rotate_ids(ogr, rc_out[None])
    ov, sat = saturate_list(ov, offset)
    dense = expand_list(ov, og, sat, q, app.dtype)

    cv_v[:, edge_ids] = torch.where(keep[..., None], cvv_rows,
                                    ov.to(cv_v.dtype))
    cv_g[:, edge_ids] = torch.where(keep[..., None], cvg_rows,
                                    og.to(cv_g.dtype))
    cv_sat[:, edge_ids] = torch.where(keep, sat_rows, sat.to(cv_sat.dtype))
    app[:, cols] = torch.where(keep[..., None], app_rows,
                               (mvc + dense).to(app.dtype))
