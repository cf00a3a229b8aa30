"""Min-convolution over the XOR group GF(2)^m, in plain torch.

Port of ``ems_nbldpc_tpu/ops/minconv.py``.  The check node writes each
output symbol ``s`` as the cheapest XOR of one symbol from each input
message, built from 2-input merges (reference forward/backward recursion,
``bubble_decoder.c:72-305``).  A merge is either the dense tropical
convolution (exact min-sum)

    out[..., s] = min_t a[..., t] + b[..., t ^ s]

or its *truncated* form (EMS)

    out[..., s] = min_j bv[..., j] + a[..., s ^ bg[..., j]]

with ``(bv, bg)`` the nm best (value, GF id) pairs of one side.  On the
GPU ``a[..., s ^ g]`` is a plain gather, so the JAX package's log2(q) roll
trick (``xor_gather``) is not carried.

Tie order: ``lax.top_k`` puts the lower index first among equal values and
``torch.topk`` gives no such guarantee, so every list whose GF ids matter
is the head of ``torch.sort(v, stable=True)``.  Where only the nm-th
*value* is used, ``torch.topk(...).values`` is exact.
"""
from __future__ import annotations

import torch

INF = 1e9


def delta_message(shape, q: int, dtype=torch.float32, device=None):
    """Identity element of minconv: cost 0 at symbol 0, INF elsewhere."""
    base = torch.full((q,), INF, dtype=dtype, device=device)
    base[0] = 0.0
    return base.expand(tuple(shape) + (q,))


def ems_input_truncate(v: torch.Tensor, nm: int) -> torch.Tensor:
    """Exclude everything outside the best ``nm`` entries of a message.

    The reference CN only sees the nm best (value, GF) pairs of each VtoC
    message (``NB_LDPC.c:354-374``); densely that is a hard exclusion
    (cost = INF).  Entries tied with the nm-th value all stay.
    """
    q = v.shape[-1]
    if nm >= q:
        return v
    kth = torch.topk(v, nm, dim=-1, largest=False).values[..., -1:]
    return torch.where(v <= kth, v, torch.full_like(v, INF))


def ems_output_saturate(v: torch.Tensor, nm: int, offset: float) -> torch.Tensor:
    """Clamp a dense CN output to its nm best entries + offset saturation.

    Every entry above the nm-th best collapses to ``nm-th best + offset``
    (the reference's re-densification fill, ``bubble_decoder.c:262-278``).
    """
    q = v.shape[-1]
    if nm >= q:
        return v
    kth = torch.topk(v, nm, dim=-1, largest=False).values[..., -1:]
    return torch.minimum(v, kth + offset)


def topk_message(v: torch.Tensor, nm: int):
    """Best-nm (ascending values, GF ids) of a dense min-cost message;
    equal values keep the lower GF id first, as ``lax.top_k`` does."""
    vals, ids = torch.sort(v, dim=-1, stable=True)
    return vals[..., :nm], ids[..., :nm]


def scatter_topk_dense(bv: torch.Tensor, bg: torch.Tensor, q: int,
                       fill: float = INF) -> torch.Tensor:
    """Dense [..., q] message from a truncated (values, GF ids) list:
    out[g] = min(fill, min of bv[j] over j with bg[j] == g).

    The JAX package's one-hot masked min, as a scatter-min: min is exact
    and order-free, so the two agree bit for bit, and no [..., nm, q]
    one-hot tensor is built (22 GB at the full-size list path's shapes).
    """
    out = torch.full(bv.shape[:-1] + (q,), fill, dtype=bv.dtype,
                     device=bv.device)
    return out.scatter_reduce_(-1, bg.long(), bv, reduce="amin")


def minconv_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense tropical XOR-convolution: out[..., s] = min_t a[..., t] +
    b[..., t ^ s].

    The JAX version gathers a [..., q, q] candidate tensor (136-272 GB at
    the flooding decoder's full width); here one candidate row per ``t``
    is added and folded in, so the peak temporary is [..., q].  Each
    candidate is one f32 add and min is exact, so the result is bit-exact
    and independent of the loop order.
    """
    q = a.shape[-1]
    s = torch.arange(q, device=a.device)
    out = None
    for t in range(q):
        cand = a[..., t, None] + b[..., t ^ s]
        out = cand if out is None else torch.minimum(out, cand)
    return out


def minconv_topk(a: torch.Tensor, bv: torch.Tensor,
                 bg: torch.Tensor) -> torch.Tensor:
    """out[..., s] = min_j bv[..., j] + a[..., s ^ bg[..., j]].

    ``a``: dense [..., q]; ``(bv, bg)``: [..., nm] list of the other side.
    Accumulates over j one candidate at a time, so the peak temporary is
    [..., q] rather than [..., nm, q].  Each candidate is one f32 add, and
    min is exact, so the result does not depend on the order over j.
    """
    q = a.shape[-1]
    s = torch.arange(q, device=a.device)
    out = None
    for j in range(bv.shape[-1]):
        cand = bv[..., j, None] + torch.gather(a, -1, bg[..., j, None] ^ s)
        out = cand if out is None else torch.minimum(out, cand)
    return out


def mask_invalid(vr: torch.Tensor, valid) -> torch.Tensor:
    """Padding slots (``valid`` False, [..., dc] bool, broadcast against
    vr's leading dims; None: no padding) become the delta message, which
    contributes nothing to a merge."""
    if valid is None:
        return vr
    neutral = delta_message(vr.shape[:-1], vr.shape[-1], vr.dtype, vr.device)
    return torch.where(valid[..., None], vr, neutral)


def fb_checknode_topk(vr: torch.Tensor, nm: int,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """F/B check node with nm-truncated combine steps (EMS semantics).

    vr: [..., dc, q] rotated inputs; valid: optional [..., dc] bool,
    False for padding slots (masked to the delta message).  The forward
    and backward chains keep dense accumulators; each combine admits only
    the nm best entries of the incoming side: the inputs' lists in the
    chains, and the backward accumulators' lists in the middle merges.
    Rows of dc <= 2 have no merge to truncate and take the dense CN.
    Returns [..., dc, q].
    """
    dc = vr.shape[-2]
    vr = mask_invalid(vr, valid)
    if dc <= 2:
        return fb_checknode_dense(vr)
    bv, bg = topk_message(vr, nm)                   # [..., dc, nm]
    msgs = [vr[..., i, :] for i in range(dc)]
    fwd = [msgs[0]]
    bwd = [msgs[-1]]
    for i in range(1, dc - 1):
        j = dc - 1 - i
        acc = torch.stack([fwd[-1], bwd[-1]], dim=-2)          # [..., 2, q]
        sv = torch.stack([bv[..., i, :], bv[..., j, :]], dim=-2)
        sg = torch.stack([bg[..., i, :], bg[..., j, :]], dim=-2)
        nxt = minconv_topk(acc, sv, sg)
        fwd.append(nxt[..., 0, :])
        bwd.append(nxt[..., 1, :])
    bwd = bwd[::-1]  # bwd[i] = conv of msgs[i+1..dc-1]
    # all middle merges in one batched combine
    tv, tg = topk_message(torch.stack(bwd[1: dc - 1], dim=-2), nm)
    mid = minconv_topk(torch.stack(fwd[: dc - 2], dim=-2), tv, tg)
    outs = [bwd[0]] + [mid[..., i, :] for i in range(dc - 2)] + [fwd[-1]]
    return torch.stack(outs, dim=-2)


def fb_checknode_dense(vr: torch.Tensor,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """Forward/backward dense CN over the dc axis (exact min-sum).

    vr: [..., dc, q] rotated inputs; valid: optional [..., dc] bool, False
    for padding slots (masked to the delta message: they contribute
    nothing, and their outputs are well-defined but unused).  dc = 1 gives
    the delta message, dc = 2 the swapped pair; otherwise 3 (dc - 2)
    ``minconv_xor`` merges, the dc - 2 middle ones batched into one call.
    Returns [..., dc, q].
    """
    dc, q = vr.shape[-2:]
    vr = mask_invalid(vr, valid)
    if dc == 1:
        return delta_message(vr.shape[:-1], q, vr.dtype, vr.device)
    if dc == 2:
        return vr.flip(-2)
    msgs = [vr[..., i, :] for i in range(dc)]
    fwd = [msgs[0]]
    bwd = [msgs[-1]]
    for i in range(1, dc - 1):
        fwd.append(minconv_xor(fwd[-1], msgs[i]))
        bwd.append(minconv_xor(bwd[-1], msgs[dc - 1 - i]))
    bwd = bwd[::-1]  # bwd[i] = conv of msgs[i+1..dc-1]
    mid = minconv_xor(torch.stack(fwd[: dc - 2], dim=-2),
                      torch.stack(bwd[1: dc - 1], dim=-2))
    outs = [bwd[0]] + [mid[..., i, :] for i in range(dc - 2)] + [fwd[-1]]
    return torch.stack(outs, dim=-2)
