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

The syndrome CN's settings (``syn``), tables (``syndrome_args``) and call
on rows (``syndrome_step``) live here too; the layered schedule shares the
settings and tables, and the bubble CNs' variant and budget
(``bubble_variant``, ``bubble_budget``).
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from ..ops.bubble_cn import bubble_rows_plain
from ..ops.cuda_bubble import bubble_rows, tile_rows
from ..ops.cuda_cn import ems_rows
from ..ops.cuda_spa import spa_checknode
from ..ops.cuda_syndrome import (check_fits, position_lists, syndrome_rows,
                                 syndrome_rows_plain)
from ..ops.fht import (position_tables, spa_checknode_plain,
                       transpose_perm_tables)
from ..ops.minconv import (delta_message, ems_input_truncate,
                           ems_output_saturate, fb_checknode_dense,
                           fb_checknode_topk)
from ..ops.syndrome_cn import syndrome_checknode, syndrome_tables
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


def syn_settings(syn) -> dict:
    """The syndrome CN's parameters: ``syn`` (the dict ``decode`` builds
    from ``DecoderConfig``'s ``syn_*`` fields, or None) over the defaults
    of ``syndrome_cn.syndrome_checknode``, whose keyword parameters they
    are (but ``offset``, which the decoder passes itself), as JAX passes
    ``**syn`` to it."""
    params = inspect.signature(syndrome_checknode).parameters
    defaults = {k: p.default for k, p in params.items()
                if p.default is not p.empty and k != "offset"}
    unknown = set(syn or {}) - set(defaults)
    if unknown:
        raise ValueError(f"syn: unknown parameters {sorted(unknown)}")
    return {**defaults, **(syn or {})}


def syn_key(syn) -> tuple:
    """``syn_settings(syn)`` as a hashable key (of table caches and device
    loops)."""
    return tuple(sorted(syn_settings(syn).items()))


def syn_nm(nm: int, q: int) -> int:
    """The syndrome CN's list length: nm, or JAX's ``min(q, 32)`` for 0."""
    return nm if nm > 0 else min(q, 32)


def _syn_host_tables(dc: int, nm: int, key: tuple):
    s = dict(key)
    return syndrome_tables(dc, nm, s["n_cv"], s["d1"], s["d2"], s["d3"],
                           s["shape"], s["max_configs"], s["sat_rule"])


@device_tables
def _syndrome_tables(dc: int, nm: int, key: tuple, device: str) -> dict:
    """The syndrome CN's config table [C, dc] uint8, saturation ranks [dc]
    int32 (``syndrome_cn.syndrome_tables``) and the kernel's per-position
    lists of the configs with no deviation there
    (``cuda_syndrome.position_lists``) on ``device``."""
    cfg, kth = _syn_host_tables(dc, nm, key)
    return dict(table=torch.as_tensor(cfg.astype(np.uint8), device=device),
                kth=torch.as_tensor(kth.astype(np.int32), device=device),
                lists=position_lists(cfg, kth, nm, device))


def syndrome_args(dc: int, q: int, nm: int, offset: float, syn,
                  device) -> tuple:
    """The syndrome CN's trailing arguments of ``cuda_syndrome``'s entries
    (table, kth, nm, offset, bayes, presort) for the decoder's nm and
    ``syn``, and the position lists, from the cache on ``device``."""
    s = syn_settings(syn)
    nm = syn_nm(nm, q)
    tabs = _syndrome_tables(dc, nm, syn_key(syn), str(device))
    return ((tabs["table"], tabs["kth"], nm, offset, s["use_bayes"],
             s["presort"]), tabs["lists"])


def syndrome_step(x, rot_in, rot_out, valid, nm: int, offset: float, syn,
                  plain: bool = False):
    """The syndrome CN step (``ops/cuda_syndrome.syndrome_rows``) on rows x
    [T, dc, q] with the decoder's nm and ``syn``; ``plain`` runs its plain
    version on any device."""
    dc, q = x.shape[1:]
    args, lists = syndrome_args(dc, q, nm, offset, syn, x.device)
    if plain:
        return syndrome_rows_plain(x, rot_in, rot_out, valid, *args)
    return syndrome_rows(x, rot_in, rot_out, valid, *args, lists)


BUBBLES = {"bubble": "8", "lbubble": "L"}  # cn_impl -> bubble_rows variant


def bubble_variant(cn: str, cn_impl: str) -> str | None:
    """The variant of ``cuda_bubble.bubble_rows`` that ``cn_impl`` selects
    ("8" for ``"bubble"``, "L" for ``"lbubble"``), or None: the EMS and
    min-sum CNs read ``cn_impl``; SPA and syndrome read none, as in JAX."""
    return BUBBLES.get(cn_impl) if cn in ("ems", "minsum") else None


def bubble_budget(nm: int, nboper: int) -> int:
    """The bubble CNs' nbOper: ``nboper``, or JAX's ``2 * nm`` for 0."""
    return nboper if nboper > 0 else 2 * nm


def check_supported(nm: int, q: int, cn: str, cn_impl: str, syn=None,
                    dc: int | None = None) -> None:
    """Raise ``ValueError`` for a CN configuration the port does not run
    (either schedule): an nm-truncated CN needs 1 <= nm <= q; the bubble
    CNs too (JAX's ``top_k(v, 0)`` breaks), and, given the rows' ``dc``,
    dc >= 3 and lists that fit the kernel (``cuda_bubble.tile_rows``); the
    syndrome CN (which reads no ``cn_impl``, as in JAX) needs 0 <= nm <= q
    and, given ``dc``, tables that its kernel reads right and holds
    (``cuda_syndrome.position_lists`` and ``check_fits``)."""
    if cn == "syndrome":
        if not 0 <= nm <= q:
            raise ValueError(f"cn='syndrome' needs 0 <= nm <= q, got nm={nm},"
                             f" q={q}")
        if dc is not None:
            s = syn_settings(syn)
            cfg, kth = _syn_host_tables(dc, syn_nm(nm, q), syn_key(syn))
            lists = position_lists(cfg, kth, syn_nm(nm, q))
            check_fits(dc, q, syn_nm(nm, q), cfg.shape[0], s["presort"],
                       "cn='syndrome'", max(lists.counts))
        return
    if cn == "spa":
        return  # the SPA CN reads neither nm nor cn_impl, as in JAX
    if cn not in ("ems", "minsum"):
        raise ValueError(f"cn={cn!r}")
    if cn_impl not in ("pallas", "topk", "auto", "dense", "list", *BUBBLES):
        raise ValueError(f"cn_impl={cn_impl!r}")
    if cn_impl in BUBBLES:
        if not 1 <= nm <= q:
            raise ValueError(f"cn_impl={cn_impl!r} needs 1 <= nm <= q, got "
                             f"nm={nm}, q={q}")
        if dc is not None and dc < 3:
            raise ValueError(f"cn_impl={cn_impl!r} needs rows of degree >= "
                             f"3, got dc={dc}")
        if dc is not None and tile_rows(dc, q, nm) < 1:
            raise ValueError(f"cn_impl={cn_impl!r}: dc={dc}, q={q}, nm={nm} "
                             f"do not fit the kernel's shared memory")
        return
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
              cn_impl: str = "auto", plain: bool = False, syn=None,
              nboper: int = 0):
    """The CN step of every row at once: rotate in, F/B CN, rotate out.

    vtoc: [F, E, q] min-normalized variable-to-check messages.  Returns
    mcv [F, E, q], min-normalized.  ``cn="spa"`` runs the hand-written
    CUDA SPA check node (``ops/cuda_spa.spa_checknode``; its plain version
    on CPU tensors, or on any device with ``plain``).  ``cn="syndrome"``
    runs the whole syndrome-EMS step (rotations, padding, lists, CN,
    normalisation) in its hand-written CUDA kernel on the unrotated rows
    (``syndrome_step`` with ``syn``; its plain version on CPU tensors, or
    on any device with ``plain``).  Otherwise ``cn_impl="pallas"`` runs the
    whole step (truncation, rotations, padding mask, CN, saturation,
    normalisation) in the hand-written CUDA EMS check node on the unrotated
    rows (``ops/cuda_cn.ems_rows``; its plain version on CPU tensors);
    ``cn_impl="bubble"`` / ``"lbubble"`` the same step with the exact
    bubble check node of budget ``bubble_budget(nm, nboper)`` and no output
    saturation, as in JAX (``ops/cuda_bubble.bubble_rows``; its plain
    version on CPU tensors, or on any device with ``plain``); and the rest
    the plain torch ``fb_checknode_topk`` or ``fb_checknode_dense`` as
    ``use_topk`` picks.
    """
    q = g.q
    f = vtoc.shape[0]
    dev = vtoc.device
    t = upload(g, str(dev))
    variant = bubble_variant(cn, cn_impl)
    if cn == "syndrome" or variant or cn != "spa" and cn_impl == "pallas":
        r = _cn_row_tables(g, str(dev))
        # a padding slot reads edge E, which the mask replaces
        src = vtoc if g.regular else torch.cat(
            [vtoc, vtoc.new_zeros((f, 1, q))], dim=1)
        rows = _rows_from_edges(g, src)                  # [F, M, dc, q]
        fm, m, dc = rows.shape[:3]
        x = rows.reshape(fm * m, dc, q)
        if cn == "syndrome":
            out = syndrome_step(x, r["rot_in"], r["rot_out"], r["valid"], nm,
                                offset, syn, plain)
        elif variant:
            out = (bubble_rows_plain if plain else bubble_rows)(
                x, r["rot_in"], r["rot_out"], r["valid"], nm,
                bubble_budget(nm, nboper), offset, truncates(cn, nm, q),
                False, variant)
        else:
            out = ems_rows(x, r["rot_in"], r["rot_out"], r["valid"], nm,
                           offset, truncates(cn, nm, q))
        return _edges_from_rows(g, out.reshape(rows.shape))
    if truncates(cn, nm, q):
        vtoc = ems_input_truncate(vtoc, nm)
    if cn == "spa":
        # rotations folded into the transform; padding slots (edge E ->
        # zero message, coefficient 0) transform to the neutral w = 1
        vt_pad = torch.cat([vtoc, vtoc.new_zeros((f, 1, q))], dim=1)
        rows = _rows_from_edges(g, vt_pad)               # [F, M, dc, q]
        s = _spa_tables(g, str(dev))
        if plain:
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
    plain: bool = False,
    syn=None,
    nboper: int = 0,
):
    """Stepped flooding decoder: ``state = init_fn(intrinsic)``, ``state =
    step_fn(state)``; state = (intrinsic, ctov_pad, decide, conv, iters).
    The intrinsic rides along unchanged (the JAX loop closes over it);
    ``init_fn(intrinsic, state)`` resets ``state`` in place, copying the
    intrinsic into its buffer (the device loop's); ``step_fn`` updates
    ctov_pad in place.  ``syn``: the syndrome CN's parameters (JAX's dict;
    ``syn_settings``); ``nboper``: the bubble CNs' budget.  ``plain`` is
    internal: it runs the SPA, syndrome and bubble CNs' plain versions on
    the card, for holding the kernels against them.
    """
    check_supported(nm, g.q, cn, cn_impl, syn, g.code.dc_max)
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
        mcv = checknode(g, vtoc, nm, offset, cn, cn_impl, plain, syn,
                        nboper)
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
                             plain=False):
    """Returns (decide [F, N] int64, iters [F] int32, converged [F] bool).
    ``syn`` is read by the syndrome CN; ``nboper`` by the bubble CNs only
    (``bubble_budget``)."""
    return host_loop(
        *make_flooding_stepper(g, nm, offset, cn, cn_impl, plain, syn,
                               nboper),
        intrinsic, max_iters)


def decode_flooding(g, intrinsic, max_iters, nm=0, offset=0.0, cn="minsum",
                    cn_impl="auto", syn=None, nboper=0):
    """The JAX ``decode_flooding`` (a ``while_loop``): the same decode as
    ``decode_flooding_hostloop``, as one replay of a captured CUDA graph on
    the card (``device_loop``; the intrinsic is copied into the loop's own
    buffer, which every step reads).  Returns (decide [F, N] int64, iters
    [F] int32, converged [F] bool)."""
    key = syn_key(syn) if cn == "syndrome" else None
    budget = bubble_budget(nm, nboper) if bubble_variant(cn, cn_impl) else 0
    return device_loop.run(
        ("flooding", g, nm, offset, cn, cn_impl, key, budget),
        lambda: make_flooding_stepper(g, nm, offset, cn, cn_impl, syn=syn,
                                      nboper=nboper),
        intrinsic, max_iters)
