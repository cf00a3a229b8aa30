"""Exact bubble-check emulation, in plain torch.

Port of ``ems_nbldpc_tpu/ops/bubble_cn.py``.  The production check nodes
(``minconv.py``, ``listcn.py``, K1) are *supersets* of the reference's
nbOper-budgeted bubble check: they consider every candidate a bubble
trajectory can reach.  This module is the exact emulation: the sequential
8-bubble ElementaryStep of the C reference's ``bubble_decoder.c:316-593``
(``variant="8"``) and the standalone v2 decoder's 4-candidate L-bubble
(``variant="L"``), at a fixed nbOper budget, with the boundary breaks and
first-index tie-breaks of ``golden.elementary_bubble`` /
``golden.elementary_lbubble``.

Every step follows the JAX version's op order: each float result is one
f32 add or subtract in the same order, with ``BIG`` = 1e5 (the reference's
"infinity") and ``minconv.INF`` = 1e9 (the delta message on padded slots)
the same f32 constants, so the results equal JAX's bit for bit.  The
nbOper loop is a Python loop of batched steps: ``torch.argmin`` keeps the
first minimal index, as ``jnp.argmin`` does.  These functions define the
op's meaning; ``ops/cuda_bubble.bubble_rows`` (K9) is the hand-written
CUDA kernel of ``bubble_rows_plain``, equal to it bit for bit.
"""
from __future__ import annotations

import functools

import torch

from .minconv import (ems_input_truncate, ems_output_saturate,
                      mask_invalid, topk_message)

BIG = 1e5  # the reference "infinity" (bubble_decoder.c:107,371)

# bubble seeds (row i into list 1, column j into list 2) and direction
# (True: moves down, i += 1; False: moves right, j += 1).  "8": rows 0..3
# at column 0 move right, row 4 at columns 0..3 moves down; "L": bubbles
# 0, 1 move right along rows 0, 1, bubbles 2, 3 down columns 0, 1 (the
# "2 rows + 2 columns" L shape, v2:1678-1684)
SEEDS = {
    "8": ((0, 1, 2, 3, 4, 4, 4, 4), (0, 0, 0, 0, 0, 1, 2, 3),
          (False,) * 4 + (True,) * 4),
    "L": ((0, 1, 2, 2), (0, 0, 0, 1), (False, False, True, True)),
}


def elementary_bubble_batch(v1, g1, v2, g2, nm: int, nb_oper: int, q: int,
                            variant: str = "8"):
    """Batched exact elementary step: [..., nm] lists -> [..., nm] lists.

    v1, v2: ascending float values (unfilled = BIG); g1, g2: poly-rep GF
    ids (unfilled = -1).  Returns (out_v, out_g int64), unfilled tail
    (BIG, -1).  The 8-bubble's seeds and advances check index bounds only
    (an unfilled slot's BIG value makes its sums ~BIG); the L-bubble's
    also check ``g >= 0``.
    """
    if variant not in SEEDS:
        raise ValueError(f"variant={variant!r}: expected '8' or 'L'")
    lead = v1.shape[:-1]
    dev, dtype = v1.device, v1.dtype
    v1, v2 = v1.reshape(-1, nm), v2.reshape(-1, nm)
    g1, g2 = g1.reshape(-1, nm).long(), g2.reshape(-1, nm).long()
    r = v1.shape[0]
    si, sj, sd = SEEDS[variant]
    nb = len(si)
    rows = torch.arange(r, device=dev)
    big = torch.full((), BIG, dtype=dtype, device=dev)
    check_ids = variant == "L"

    def cand(i, j):
        """v1[i] + v2[j] where (i, j) is in range (and, "L", both ids are
        filled), else BIG; i, j: [r] or [r, nb]."""
        ic, jc = i.clamp(max=nm - 1), j.clamp(max=nm - 1)
        ok = (i < nm) & (j < nm)
        if check_ids:
            ok = ok & (g1.gather(-1, ic) >= 0) & (g2.gather(-1, jc) >= 0)
        return torch.where(ok, v1.gather(-1, ic) + v2.gather(-1, jc), big)

    bi = torch.tensor(si, device=dev).expand(r, nb).contiguous()
    bj = torch.tensor(sj, device=dev).expand(r, nb).contiguous()
    down = torch.tensor(sd, device=dev)
    bv = cand(bi, bj)
    out_v = torch.full((r, nm), BIG, dtype=dtype, device=dev)
    out_g = torch.full((r, nm), -1, dtype=torch.long, device=dev)
    seen = torch.zeros((r, q), dtype=torch.bool, device=dev)
    s = torch.zeros(r, dtype=torch.long, device=dev)
    done = torch.zeros(r, dtype=torch.bool, device=dev)
    for _ in range(nb_oper):
        pos = bv.argmin(dim=-1)               # the first minimal bubble
        i, j, cur = bi[rows, pos], bj[rows, pos], bv[rows, pos]
        gi = g1[rows, i.clamp(max=nm - 1)]
        gj = g2[rows, j.clamp(max=nm - 1)]
        # validity break BEFORE the output write (golden.py:61-62,113-114)
        done = done | (i >= nm) | (j >= nm) | (gi < 0) | (gj < 0)
        gf = (gi ^ gj) & (q - 1)
        new = ~done & ~seen[rows, gf]
        sc = s.clamp(max=nm - 1)
        out_v[rows, sc] = torch.where(new, cur, out_v[rows, sc])
        out_g[rows, sc] = torch.where(new, gf, out_g[rows, sc])
        seen[rows, gf] = seen[rows, gf] | new
        s = s + new.long()
        # the budget of nm outputs, then the boundary break after the
        # write (golden.py:72-74,123-124)
        done = done | (s >= nm) | (i >= nm - 1) | (j >= nm - 1)
        dn = down[pos]
        ni = torch.where(dn, i + 1, i)
        nj = torch.where(dn, j, j + 1)
        nv = cand(ni[:, None], nj[:, None])[:, 0]
        bv[rows, pos] = torch.where(done, cur, nv)
        bi[rows, pos] = torch.where(done, i, ni)
        bj[rows, pos] = torch.where(done, j, nj)
    return out_v.reshape(lead + (nm,)), out_g.reshape(lead + (nm,))


def fb_checknode_bubble(vr_rows, nm: int, nb_oper: int, offset: float,
                        variant: str = "8", valid=None):
    """Exact F/B bubble-check CN on rotated dense rows.

    vr_rows: [..., dc, q] rotated (coefficient-multiplied) dense min-cost
    messages, dc >= 3.  Each slot's nm best (``minconv.topk_message``:
    lower id first among ties, as ``lax.top_k``), normalised to their
    minimum; dc - 2 forward and dc - 2 backward elementary steps, then
    dc - 2 combining ones.  Returns dense [..., dc, q] outputs in the
    rotated domain, offset-saturated like ``golden.check_pass_ems``
    (``bubble_decoder.c:249-278``): fill value (last kept) + offset, where
    "last" is the largest kept value; a slot with no kept entry is a
    uniform ``offset``.  ``valid`` ([..., dc] bool) zeroes padded slots.
    """
    dc, q = vr_rows.shape[-2], vr_rows.shape[-1]
    if dc < 3:
        raise ValueError(f"the bubble check node needs dc >= 3, got {dc}")
    vals, gfs = topk_message(vr_rows, nm)            # [..., dc, nm]
    # the reference normalizes each sorted list to its min (NB_LDPC.c:371)
    vals = vals - vals[..., :1]

    elem = functools.partial(elementary_bubble_batch, nm=nm,
                             nb_oper=nb_oper, q=q, variant=variant)
    fwd = [(vals[..., 0, :], gfs[..., 0, :])]
    bwd = [(vals[..., dc - 1, :], gfs[..., dc - 1, :])]
    for t in range(1, dc - 1):
        u = dc - 1 - t
        fwd.append(elem(*fwd[-1], vals[..., t, :], gfs[..., t, :]))
        bwd.append(elem(*bwd[-1], vals[..., u, :], gfs[..., u, :]))
    # after reversal, bwd[i] is the merge of slots i+1..dc-1; fwd[i] is
    # the merge of slots 0..i
    bwd = bwd[::-1]
    outs = [bwd[0]]
    for t in range(1, dc - 1):
        outs.append(elem(*fwd[t - 1], *bwd[t]))
    outs.append(fwd[dc - 2])
    ov = torch.stack([o[0] for o in outs], dim=-2)    # [..., dc, nm]
    og = torch.stack([o[1] for o in outs], dim=-2)

    filled = og >= 0
    any_filled = filled.any(dim=-1, keepdim=True)
    last = torch.where(filled, ov, torch.full_like(ov, -BIG)).amax(
        dim=-1, keepdim=True)
    sat = torch.where(any_filled, last + offset, torch.full_like(last, offset))
    # the kept entries over a dense [q] vector filled with sat; unfilled
    # slots go to a q-th scratch lane (kept ids are distinct: GF dedup)
    og_safe = torch.where(filled, og, q)
    put = torch.where(filled, ov, sat)
    dense = torch.zeros(ov.shape[:-1] + (q + 1,), dtype=ov.dtype,
                        device=ov.device) + sat
    out = dense.scatter_(-1, og_safe, put)[..., :q]
    if valid is not None:
        out = torch.where(valid[..., None], out, 0.0)
    return out


def bubble_rows_plain(x, rot_in, rot_out, valid, nm: int, nb_oper: int,
                      offset: float, truncate: bool, saturate: bool,
                      variant: str = "8") -> torch.Tensor:
    """The bubble check-node step on a batch of unrotated rows, the plain
    torch composition that ``cuda_bubble.bubble_rows`` (K9) fuses.

    x: [T, dc, q] float32 unrotated, min-normalised VN-to-CN rows; row t
    uses row ``t % G`` of ``rot_in`` / ``rot_out`` ([G, dc, q] gather
    tables) and ``valid`` ([G, dc] bool, None: no padding).  In the JAX
    package's order: truncate to the nm best (``truncate``), rotate in,
    padded slots to the delta message, ``fb_checknode_bubble``, rotate
    out, the output saturation (``saturate``: the layered schedule's
    ``ems_output_saturate``), subtract each message's minimum.  Returns
    [T, dc, q].
    """
    t, dc, q = x.shape
    g = rot_in.shape[0]
    v = x.reshape(t // g, g, dc, q)
    if truncate:
        v = ems_input_truncate(v, nm)
    v = torch.gather(v, -1, rot_in.long().expand_as(v))
    v = mask_invalid(v, valid)
    out = fb_checknode_bubble(v, nm, nb_oper, offset, variant)
    out = torch.gather(out, -1, rot_out.long().expand_as(out))
    if saturate:
        out = ems_output_saturate(out, nm, offset)
    out = out - out.min(dim=-1, keepdim=True).values
    return out.reshape(t, dc, q)
