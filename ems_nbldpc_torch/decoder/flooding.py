"""Flooding-schedule decoder, batched over frames.

Port of ``ems_nbldpc_tpu/decoder/flooding.py``.  One iteration updates
*all* M check nodes from the previous iteration's messages, the maximally
parallel schedule (the reference's layered loop at ``NB_LDPC.c:313-472``
is the serial special case; see layered.py).  All tensors are
``[F, ..., q]`` with F = frames.

State: CtoV [F, E+1, q] (its padding edge E is the target of padded
column slots and stays 0).  There is no stored APP: the totals are
``intrinsic + (sum of incident CtoV)``, recomputed every step in that
grouping, so decisions are bit-exact against the JAX package.

Early termination: the per-frame syndrome check (``NB_LDPC.c:468-471``,
``tools.c:284-299``) becomes a convergence mask; decisions latch at the
first syndrome-zero iteration, converged frames keep their CtoV, and the
loop stops when every frame has converged or the iteration budget is
spent: ``host_loop`` (shared with layered.py) polls on the host,
``decode_flooding`` runs ``device_loop``'s captured graph.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_cn import ems_rows
from ..ops.cuda_spa import spa_checknode
from ..ops.fht import (position_tables, spa_checknode_plain,
                       transpose_perm_tables)
from ..ops.minconv import (delta_message, ems_input_truncate,
                           ems_output_saturate, fb_checknode_dense,
                           fb_checknode_topk)
from . import device_loop
from .graph import (DeviceGraph, device_tables, rotate, rotation_table,
                    upload)


def syndrome_ok(g: DeviceGraph, decide: torch.Tensor) -> torch.Tensor:
    """[F, N] hard decisions -> [F] bool all-checks-satisfied.

    u_e = h_e * decide[col_e] (GF multiply through the flat [q*q] table),
    then XOR-reduce per row (GF add = XOR in polynomial representation).
    The reference's ``Syndrom`` (``tools.c:284-299``), batched.
    """
    t = upload(g, str(decide.device))
    sym = decide[:, t["edge_col"]].long()                   # [F, E]
    u = t["mul_flat"][t["edge_coef"] * g.q + sym]           # [F, E]
    u_pad = torch.nn.functional.pad(u, (0, 1))              # pad edge -> 0
    u_rows = u_pad[:, t["row_edges"]]                       # [F, M, dc]
    synd = u_rows[..., 0]
    for i in range(1, u_rows.shape[-1]):
        synd = synd ^ u_rows[..., i]
    return (synd == 0).all(dim=-1)


def use_topk(cn: str, nm: int, q: int, cn_impl: str) -> bool:
    if cn_impl == "topk":
        return True
    if cn_impl == "dense":
        return False
    # auto: the truncated combine whenever nm is well below q
    return cn == "ems" and 0 < nm <= q // 2


def truncates(cn: str, nm: int, q: int) -> bool:
    """Whether the CN truncates its inputs to their nm best and saturates
    its outputs: EMS with 0 < nm < q (``nm = 0``: no truncation, the
    ``DecoderConfig`` meaning, so EMS is then the exact min-sum CN)."""
    return cn == "ems" and 0 < nm < q


def check_supported(nm: int, q: int, cn: str, cn_impl: str) -> None:
    """Raise for a CN configuration the port does not run (either
    schedule): the syndrome and bubble CNs are not ported yet, and an
    nm-truncated CN needs 1 <= nm <= q."""
    if cn == "syndrome":
        raise NotImplementedError(
            "cn='syndrome' is not ported yet (ROADMAP Queue 1: the syndrome "
            "CN)")
    if cn_impl in ("bubble", "lbubble"):
        raise NotImplementedError(
            f"cn_impl={cn_impl!r} is not ported yet (ROADMAP Queue 1: exact "
            "bubble emulation)")
    if cn == "spa":
        return  # the SPA CN reads neither nm nor cn_impl, as in JAX
    if cn not in ("ems", "minsum"):
        raise ValueError(f"cn={cn!r}")
    if cn_impl not in ("pallas", "topk", "auto", "dense", "list"):
        raise ValueError(f"cn_impl={cn_impl!r}")
    truncated = (cn == "ems" and nm != 0 or cn_impl == "pallas"
                 or use_topk(cn, nm, q, cn_impl))
    if truncated and not 1 <= nm <= q:
        raise ValueError(f"cn={cn!r}, cn_impl={cn_impl!r} needs 1 <= nm <= "
                         f"q, got nm={nm}, q={q}")


def decision_buffers(intrinsic):
    """Empty (decide [F, N] int64, conv [F] bool, iters [F] int32)."""
    f, n = intrinsic.shape[:2]
    dev = intrinsic.device
    return (torch.empty((f, n), dtype=torch.int64, device=dev),
            torch.empty(f, dtype=torch.bool, device=dev),
            torch.empty(f, dtype=torch.int32, device=dev))


@device_tables
def _spa_tables(g: DeviceGraph, device: str) -> dict:
    """The SPA CN's row coefficients [M, dc] int32 (0 = padding), the
    code's ``transpose_perm_tables`` and their per-position tables."""
    t_tab, tinv_tab = (torch.as_tensor(t, device=device)
                       for t in transpose_perm_tables(g.code.gf))
    coefs = torch.as_tensor(g.code.row_coefs, dtype=torch.int32,
                            device=device)
    t_in, t_out = position_tables(coefs, t_tab, tinv_tab)
    return dict(coefs=coefs, t_tab=t_tab, tinv_tab=tinv_tab, t_in=t_in,
                t_out=t_out)


@device_tables
def _cn_row_tables(g: DeviceGraph, device: str) -> dict:
    """The CUDA EMS check node's per-row tables: rot_in / rot_out
    [M, dc, q] uint8 from the row coefficients (0 = padding: identity),
    and valid [M, dc] bool (None for a regular code)."""
    code = g.code
    shape = code.row_coefs.shape + (g.q,)
    tabs = {d: torch.as_tensor(rotation_table(code.row_coefs, code.gf, d)
                               .reshape(shape).astype(np.uint8),
                               device=device) for d in ("in", "out")}
    valid = None if g.regular else torch.as_tensor(g.edge_valid_row,
                                                   device=device)
    return dict(rot_in=tabs["in"], rot_out=tabs["out"], valid=valid)


@device_tables
def _edge_rotations(g: DeviceGraph, device: str):
    """Per-edge rotation tables (rot_in, rot_out), [E, q] int64 each, for
    the plain torch CNs; only the flooding schedule reads them (layered.py
    keeps per-layer ones)."""
    code = g.code
    return tuple(torch.as_tensor(rotation_table(code.edge_coef, code.gf, d),
                                 device=device) for d in ("in", "out"))


def _vn_totals(g: DeviceGraph, intrinsic, ctov_pad):
    """APP totals: intrinsic + (sum of incident CtoV).  [F, N, q].

    The incident messages are gathered one column slot at a time (peak
    [F, N, q], not [F, N, dv, q]) and summed left to right, as the JAX
    reduction over dv does."""
    ce = upload(g, str(ctov_pad.device))["col_edges"]
    inc = ctov_pad[:, ce[:, 0]]
    for j in range(1, ce.shape[1]):
        inc = inc + ctov_pad[:, ce[:, j]]
    return intrinsic + inc


def _rows_from_edges(g: DeviceGraph, x_pad):
    """[F, E+1, q] -> [F, M, dc, q] via the row-edge gather."""
    return x_pad[:, upload(g, str(x_pad.device))["row_edges"]]


def _edges_from_rows(g: DeviceGraph, x_rows):
    """[F, M, dc, q] -> [F, E, q]."""
    t = upload(g, str(x_rows.device))
    return x_rows[:, t["edge_row"], t["edge_slot"]]


def checknode(g: DeviceGraph, vtoc, nm: int, offset: float, cn: str,
              cn_impl: str = "auto", plain_spa: bool = False):
    """The CN step of every row at once: rotate in, F/B CN, rotate out.

    vtoc: [F, E, q] min-normalized variable-to-check messages.  Returns
    mcv [F, E, q], min-normalized.  ``cn="spa"`` runs the hand-written
    CUDA SPA check node (``ops/cuda_spa.spa_checknode``; its plain version
    on CPU tensors, or on any device with ``plain_spa``).  Otherwise
    ``cn_impl="pallas"`` runs the whole step (truncation, rotations,
    padding mask, CN, saturation, normalisation) in the hand-written CUDA
    EMS check node on the unrotated rows (``ops/cuda_cn.ems_rows``; its
    plain version on CPU tensors), and the rest the plain torch
    ``fb_checknode_topk`` or ``fb_checknode_dense`` as ``use_topk`` picks.
    """
    q = g.q
    f = vtoc.shape[0]
    dev = vtoc.device
    t = upload(g, str(dev))
    if cn != "spa" and cn_impl == "pallas":
        r = _cn_row_tables(g, str(dev))
        # a padding slot reads edge E, which the mask replaces
        src = vtoc if g.regular else torch.cat(
            [vtoc, vtoc.new_zeros((f, 1, q))], dim=1)
        rows = _rows_from_edges(g, src)                  # [F, M, dc, q]
        fm, m, dc = rows.shape[:3]
        out = ems_rows(rows.reshape(fm * m, dc, q), r["rot_in"],
                       r["rot_out"], r["valid"], nm, offset,
                       truncates(cn, nm, q))
        return _edges_from_rows(g, out.reshape(rows.shape))
    if truncates(cn, nm, q):
        vtoc = ems_input_truncate(vtoc, nm)
    if cn == "spa":
        # rotations folded into the transform; padding slots (edge E ->
        # zero message, coefficient 0) transform to the neutral w = 1
        vt_pad = torch.cat([vtoc, vtoc.new_zeros((f, 1, q))], dim=1)
        rows = _rows_from_edges(g, vt_pad)               # [F, M, dc, q]
        s = _spa_tables(g, str(dev))
        if plain_spa:
            mcv_rows = spa_checknode_plain(rows, s["t_in"], s["t_out"])
        else:
            fm, m, dc = rows.shape[:3]
            mcv_rows = spa_checknode(rows.reshape(fm * m, dc, q), s["coefs"],
                                     s["t_tab"], s["tinv_tab"]
                                     ).reshape(rows.shape)
        mcv = _edges_from_rows(g, mcv_rows)
        return mcv - mcv.min(dim=-1, keepdim=True).values
    rot_in, rot_out = _edge_rotations(g, str(dev))
    vr = rotate(vtoc, rot_in)
    pad = delta_message((f, 1), q, vr.dtype, dev)
    vr_rows = _rows_from_edges(g, torch.cat([vr, pad], dim=1))
    valid = None if g.regular else t["edge_valid_row"][None]
    if use_topk(cn, nm, q, cn_impl):
        mcv_rows = fb_checknode_topk(vr_rows, nm, valid)
    else:
        mcv_rows = fb_checknode_dense(vr_rows, valid)
    mcv = rotate(_edges_from_rows(g, mcv_rows), rot_out)
    if truncates(cn, nm, q):
        # output saturation: entries beyond the nm best are clamped to
        # (nm-th best + offset), the fill rule of bubble_decoder.c:262-278
        mcv = ems_output_saturate(mcv, nm, offset)
    return mcv - mcv.min(dim=-1, keepdim=True).values


def make_flooding_stepper(
    g: DeviceGraph,
    nm: int = 0,
    offset: float = 0.0,
    cn: str = "minsum",
    cn_impl: str = "auto",
    plain_spa: bool = False,
):
    """Stepped flooding decoder: ``state = init_fn(intrinsic)``, ``state =
    step_fn(state)``; state = (intrinsic, ctov_pad, decide, conv, iters).
    The intrinsic rides along unchanged (the JAX loop closes over it);
    ``init_fn(intrinsic, state)`` resets ``state`` in place, copying the
    intrinsic into its buffer (the device loop's); ``step_fn`` updates
    ctov_pad in place.  ``plain_spa`` is internal: it runs the SPA CN's
    plain version on the card, for holding the kernel against it.
    """
    check_supported(nm, g.q, cn, cn_impl)
    e = g.n_edges

    def decisions(intrinsic, ctov_pad):
        return _vn_totals(g, intrinsic, ctov_pad).argmin(dim=-1)

    def init_fn(intrinsic, state=None):
        if state is None:
            f, _, q = intrinsic.shape
            state = (intrinsic, intrinsic.new_empty((f, e + 1, q))
                     ) + decision_buffers(intrinsic)
        intr, ctov, decide, conv, iters = state
        if intr is not intrinsic:
            intr.copy_(intrinsic)
        ctov.zero_()
        decide.copy_(decisions(intr, ctov))
        conv.copy_(syndrome_ok(g, decide))
        iters.zero_()
        return state

    def step_fn(state):
        intrinsic, ctov_pad, decide, conv, iters = state
        edge_col = upload(g, str(intrinsic.device))["edge_col"]
        tot = _vn_totals(g, intrinsic, ctov_pad)
        vtoc = tot[:, edge_col] - ctov_pad[:, :e]
        del tot
        vtoc = vtoc - vtoc.min(dim=-1, keepdim=True).values
        mcv = checknode(g, vtoc, nm, offset, cn, cn_impl, plain_spa)
        del vtoc
        active = ~conv
        # converged frames keep their CtoV; the padding edge stays 0
        ctov_pad[:, :e] = torch.where(active[:, None, None], mcv,
                                      ctov_pad[:, :e])
        del mcv
        decide = torch.where(active[:, None],
                             decisions(intrinsic, ctov_pad), decide)
        conv = conv | syndrome_ok(g, decide)
        return (intrinsic, ctov_pad, decide, conv,
                iters + active.to(torch.int32))

    return init_fn, step_fn


def host_loop(init_fn, step_fn, intrinsic, max_iters):
    """Step until every frame has converged or the budget is spent,
    polling ``conv.all()`` on the host once per iteration (the JAX
    while_loop's ``cond``).  Returns (decide [F, N] int64, iters [F]
    int32, converged [F] bool)."""
    state = init_fn(intrinsic)
    for _ in range(max_iters):
        if bool(state[-2].all()):
            break
        state = step_fn(state)
    return state[-3], state[-1], state[-2]


def decode_flooding_hostloop(g, intrinsic, max_iters, nm=0, offset=0.0,
                             cn="minsum", cn_impl="auto", syn=None, nboper=0,
                             plain_spa=False):
    """Returns (decide [F, N] int64, iters [F] int32, converged [F] bool).
    ``syn`` and ``nboper`` are read by the syndrome and bubble CNs only,
    which raise (not ported yet)."""
    return host_loop(
        *make_flooding_stepper(g, nm, offset, cn, cn_impl, plain_spa),
        intrinsic, max_iters)


def decode_flooding(g, intrinsic, max_iters, nm=0, offset=0.0, cn="minsum",
                    cn_impl="auto", syn=None, nboper=0):
    """The JAX ``decode_flooding`` (a ``while_loop``): the same decode as
    ``decode_flooding_hostloop``, as one replay of a captured CUDA graph on
    the card (``device_loop``; the intrinsic is copied into the loop's own
    buffer, which every step reads).  Returns (decide [F, N] int64, iters
    [F] int32, converged [F] bool)."""
    return device_loop.run(
        ("flooding", g, nm, offset, cn, cn_impl),
        lambda: make_flooding_stepper(g, nm, offset, cn, cn_impl),
        intrinsic, max_iters)
