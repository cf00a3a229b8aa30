"""Layered (horizontal) schedule over column-disjoint super-layers.

Port of the host-loop paths of ``ems_nbldpc_tpu/decoder/layered.py``:
the dense-storage sweep (``_layer_plan``, ``_make_dense_iteration`` with
its SPA and syndrome branches and, through ``_make_rotated_cn``, its EMS
(``cn_impl`` pallas / topk) and dense min-conv branches,
``make_layered_stepper``, ``decode_layered_hostloop``), the same sweep
with nm-compressed CtoV storage (``make_layered_compressed_stepper``,
``decode_layered_compressed``), and the truncated-list EMS sweep with
compressed CtoV storage (``_make_list_iteration_unrolled``,
``_list_init_state``, ``make_layered_list_stepper``,
``decode_layered_list_hostloop``).  Rows that share no variable commute,
so each super-layer (host colouring, ``models/code.py``) is one batched CN
step.

State: APP [F, N+1, q] and CtoV ([F, E+1, q] dense, or the nm-truncated
(vals, ids, sat) triple), each with the JAX package's padding column /
edge (the target of padded row slots).  The JAX version's functional
``.at[].set`` scatters become in-place indexed assignment on the state
tensors: a super-layer's columns and edges are disjoint, so every written
element has one writer (padded slots all write the same value).

Per super-layer (the reference's ``NB_LDPC.c:320-466``):
  mvc  = APP[cols] - CtoV[edges]      (VN extrinsic), minus its min
  mcv  = CN(mvc)                      (EMS / min-sum: rotate, truncate,
                                       F/B, rotate back, saturate; SPA:
                                       rotations folded into the transform)
  CtoV[edges] = mcv,  APP[cols] = mvc + mcv   (frozen frames keep theirs)
For ``cn="spa"`` and ``cn="syndrome"`` on the card the whole of it is one
kernel launch (``ops/cuda_spa.spa_layer``, ``ops/cuda_syndrome.
syndrome_layer``), with no [F, G, dc, q] temporaries; for ``cn_impl``
pallas, bubble and lbubble the CN step is (``ops/cuda_cn.ems_rows``,
``ops/cuda_bubble.bubble_rows``) between torch gathers and scatters.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import listcn
from ..ops.bubble_cn import bubble_rows_plain
from ..ops.cuda_bubble import bubble_rows
from ..ops.cuda_cn import ems_rows
from ..ops.cuda_spa import spa_layer, spa_layer_plain
from ..ops.cuda_syndrome import syndrome_layer, syndrome_layer_plain
from ..ops.fht import transpose_perm_tables
from ..ops.minconv import (ems_input_truncate, ems_output_saturate,
                           fb_checknode_dense, fb_checknode_topk,
                           mask_invalid, scatter_topk_dense, topk_message)
from . import device_loop
from .flooding import (bubble_budget, bubble_variant, check_supported,
                       decision_buffers, host_loop, syn_key, syndrome_args,
                       syndrome_ok, truncates, use_topk)
from .graph import DeviceGraph, device_tables, rotate, rotation_table


@device_tables
def _layer_plan(g: DeviceGraph, device: str):
    """Per-layer index tensors on ``device``: gathers (int64, and int32
    copies for the SPA kernel), the coefficients, and their rotation
    tables (EMS: dense gathers, also as the uint8 [G, dc, q] tables of the
    CUDA check node; SPA: the code's transform-domain permutations; list
    EMS: GF(2)-basis columns)."""
    e = g.n_edges
    n = g.code.n
    dc = g.code.dc_max
    gf = g.code.gf
    t_tab, tinv_tab = (torch.as_tensor(t, device=device)
                       for t in transpose_perm_tables(gf))

    def up(a, dtype=np.int64):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    plans = []
    for rows in g.layers:
        rows = np.asarray(rows)
        edge_ids = g.row_edges[rows]
        cols = np.concatenate([g.code.row_cols, np.full((1, dc), n)])[rows]
        valid = edge_ids < e
        coefs = g.code.row_coefs[rows]
        rot_in, rot_out = (rotation_table(coefs, gf, d)
                           for d in ("in", "out"))
        plans.append(dict(
            edge_ids=up(edge_ids),
            cols=up(cols),
            edge_ids32=up(edge_ids, np.int32),
            cols32=up(cols, np.int32),
            # None for full rows: the neutral-message mask is then a no-op
            valid=None if valid.all() else torch.as_tensor(valid, device=device),
            rot_in=up(rot_in),
            rot_out=up(rot_out),
            rot_in8=up(rot_in.reshape(len(rows), dc, -1), np.uint8),
            rot_out8=up(rot_out.reshape(len(rows), dc, -1), np.uint8),
            coefs=up(coefs, np.int32),
            t_tab=t_tab, tinv_tab=tinv_tab,
            rc_in=up(listcn.mul_cols(gf, coefs), np.int32),
            rc_out=up(listcn.mul_cols(gf, coefs, inverse=True), np.int32),
            shape=(len(rows), dc),
        ))
    return plans


def _make_rotated_cn(g: DeviceGraph, nm, cn, cn_impl):
    """``rotated_cn(mvc, p)``: one super-layer's plain torch EMS / min-sum
    CN on the min-normalized [F, G, dc, q] extrinsics of plan ``p``
    (truncate, rotate in, mask padded slots, F/B CN, rotate out; no
    saturation); ``use_topk`` picks ``fb_checknode_topk`` or the dense
    ``fb_checknode_dense``.  (``cn_impl="pallas"`` takes the fused CUDA
    step instead, in ``_make_dense_iteration``.)"""
    q = g.q
    check_supported(nm, q, cn, cn_impl)
    truncate = truncates(cn, nm, q)
    topk_cn = use_topk(cn, nm, q, cn_impl)

    def rotated_cn(mvc, p):
        f = mvc.shape[0]
        gdim, dcdim = p["shape"]
        mvc_cn = ems_input_truncate(mvc, nm) if truncate else mvc
        vr = rotate(mvc_cn.reshape(f, gdim * dcdim, q), p["rot_in"])
        vr = mask_invalid(vr.reshape(mvc.shape), p["valid"])
        if topk_cn:
            mcv_r = fb_checknode_topk(vr, nm)
        else:
            mcv_r = fb_checknode_dense(vr)
        mcv = rotate(mcv_r.reshape(f, gdim * dcdim, q), p["rot_out"])
        return mcv.reshape(mvc.shape)

    return rotated_cn


def _make_dense_iteration(g: DeviceGraph, nm, offset, cn, cn_impl,
                          plain=False, syn=None, nboper=0):
    """The per-iteration CN sweep over all super-layers, dense CtoV:
    ``one_iteration(app, ctov, active)`` updates the state in place.
    ``cn="spa"``: one ``ops/cuda_spa.spa_layer`` call per super-layer, the
    whole step (gathers, normalisation, check node, freeze, write-back) in
    one hand-written CUDA kernel launch (its plain version
    ``spa_layer_plain`` on CPU tensors); ``plain`` runs the plain version
    on any device, for comparing the two.
    ``cn="syndrome"``: one ``ops/cuda_syndrome.syndrome_layer`` call per
    super-layer with the tables of ``syn`` (``flooding.syndrome_args``),
    the whole step in one hand-written CUDA kernel launch (its plain
    version ``syndrome_layer_plain`` on CPU tensors, or on any device with
    ``plain``); no output saturation, as in JAX.
    ``cn="ems"``/``"minsum"`` with ``cn_impl="pallas"``: the hand-written
    CUDA kernel does the whole CN step, normalisation included
    (``ops/cuda_cn.ems_rows``; its plain version on CPU tensors); with
    ``cn_impl="bubble"`` / ``"lbubble"`` the exact bubble check node of
    budget ``flooding.bubble_budget(nm, nboper)`` does, output saturation
    included where EMS truncates, as in JAX (``ops/cuda_bubble.
    bubble_rows``; its plain version on CPU tensors, or on any device with
    ``plain``); other ``cn_impl``: ``_make_rotated_cn``, then (EMS) output
    saturation and normalisation.
    """
    q = g.q
    check_supported(nm, q, cn, cn_impl, syn, g.code.dc_max)

    if cn == "spa":
        layer_step = spa_layer_plain if plain else spa_layer

        def spa_iteration(app, ctov, active):
            for p in _layer_plan(g, str(app.device)):
                layer_step(app, ctov, active, p["cols32"], p["edge_ids32"],
                           p["coefs"], p["t_tab"], p["tinv_tab"])

        return spa_iteration

    if cn == "syndrome":
        dc = g.code.dc_max

        def syndrome_iteration(app, ctov, active):
            args, lists = syndrome_args(dc, q, nm, offset, syn, app.device)
            for p in _layer_plan(g, str(app.device)):
                layer = (app, ctov, active, p["cols32"], p["edge_ids32"],
                         p["rot_in8"], p["rot_out8"], p["valid"], *args)
                if plain:
                    syndrome_layer_plain(*layer)
                else:
                    syndrome_layer(*layer, lists)

        return syndrome_iteration

    truncate = truncates(cn, nm, q)
    variant = bubble_variant(cn, cn_impl)
    # the kernels' steps normalise
    fused = cn_impl == "pallas" or variant is not None

    def fused_cn(mvc, p):
        f, gdim, dcdim, _ = mvc.shape
        rows = (mvc.reshape(f * gdim, dcdim, q), p["rot_in8"], p["rot_out8"],
                p["valid"], nm)
        if variant:
            out = (bubble_rows_plain if plain else bubble_rows)(
                *rows, bubble_budget(nm, nboper), offset, truncate, truncate,
                variant)
        else:
            out = ems_rows(*rows, offset, truncate)
        return out.reshape(mvc.shape)

    if fused:
        check_node = fused_cn
    else:
        rotated_cn = _make_rotated_cn(g, nm, cn, cn_impl)

        def check_node(mvc, p):
            mcv = rotated_cn(mvc, p)
            return ems_output_saturate(mcv, nm, offset) if truncate else mcv

    def one_iteration(app, ctov, active):
        act = active[:, None, None, None]
        for p in _layer_plan(g, str(app.device)):
            app_rows = app[:, p["cols"]]                 # [F, G, dc, q]
            ctov_rows = ctov[:, p["edge_ids"]]
            mvc = app_rows - ctov_rows
            mvc = mvc - mvc.min(dim=-1, keepdim=True).values
            mcv = check_node(mvc, p)
            if not fused:
                mcv = mcv - mcv.min(dim=-1, keepdim=True).values
            # freeze converged frames (their APP/CtoV stop changing)
            mcv = torch.where(act, mcv, ctov_rows)
            new_app = torch.where(act, mvc + mcv, app_rows)
            ctov[:, p["edge_ids"]] = mcv
            app[:, p["cols"]] = new_app

    return one_iteration


def _step_decisions(g, app, decide, conv, iters, active):
    """Decisions, convergence and iteration counts after one sweep."""
    d_new = app[:, :g.code.n].argmin(dim=-1)
    decide = torch.where(active[:, None], d_new, decide)
    conv = conv | syndrome_ok(g, decide)
    return decide, conv, iters + active.to(torch.int32)


def _reset(g, state, intrinsic):
    """In place: APP (``state[0]``) = the intrinsic with the padding column
    0 (``copy_`` rounds as ``.to(dtype)``), and the initial (decide, conv,
    iters) in ``state[-3:]``; returns ``state``."""
    app = state[0]
    n = intrinsic.shape[1]
    app[:, :n].copy_(intrinsic)
    app[:, n:].zero_()
    decide, conv, iters = state[-3:]
    decide.copy_(app[:, :n].argmin(dim=-1))
    conv.copy_(syndrome_ok(g, decide))
    iters.zero_()
    return state


def make_layered_stepper(
    g: DeviceGraph,
    nm: int = 0,
    offset: float = 0.0,
    cn: str = "minsum",
    cn_impl: str = "auto",
    plain: bool = False,
    syn=None,
    nboper: int = 0,
):
    """Stepped decoder: ``state = init_fn(intrinsic)``, ``state =
    step_fn(state)``; state = (app, ctov, decide, conv, iters).
    ``init_fn(intrinsic, state)`` resets ``state`` in place (the device
    loop's buffers); ``step_fn`` updates app and ctov in place and returns
    the new state.  ``syn``: the syndrome CN's parameters (JAX's dict;
    ``flooding.syn_settings``); ``nboper``: the bubble CNs' budget.
    ``plain`` is internal: it runs the SPA, syndrome and bubble CNs' plain
    versions on the card, for holding the kernels against them.
    """
    q, e = g.q, g.n_edges
    one_iteration = _make_dense_iteration(g, nm, offset, cn, cn_impl, plain,
                                          syn, nboper)

    def init_fn(intrinsic, state=None):
        if state is None:
            f, n = intrinsic.shape[:2]
            state = (intrinsic.new_empty((f, n + 1, q)),
                     intrinsic.new_empty((f, e + 1, q))
                     ) + decision_buffers(intrinsic)
        state[1].zero_()
        return _reset(g, state, intrinsic)

    def step_fn(state):
        app, ctov, decide, conv, iters = state
        active = ~conv
        one_iteration(app, ctov, active)
        return (app, ctov) + _step_decisions(g, app, decide, conv, iters,
                                             active)

    return init_fn, step_fn


def decode_layered_hostloop(g, intrinsic, max_iters, nm=0, offset=0.0,
                            cn="minsum", cn_impl="auto", syn=None, nboper=0,
                            plain=False):
    """Returns (decide [F, N] int64, iters [F] int32, converged [F] bool).
    ``syn`` is read by the syndrome CN; ``nboper`` by the bubble CNs only
    (``flooding.bubble_budget``)."""
    return host_loop(
        *make_layered_stepper(g, nm, offset, cn, cn_impl, plain, syn,
                              nboper),
        intrinsic, max_iters)


def decode_layered(g, intrinsic, max_iters, nm=0, offset=0.0, cn="minsum",
                   cn_impl="auto", syn=None, nboper=0):
    """The JAX ``decode_layered`` (a ``while_loop``): the same decode as
    ``decode_layered_hostloop``, as one replay of a captured CUDA graph on
    the card (``device_loop``).  Returns (decide [F, N] int64, iters [F]
    int32, converged [F] bool)."""
    key = syn_key(syn) if cn == "syndrome" else None
    budget = bubble_budget(nm, nboper) if bubble_variant(cn, cn_impl) else 0
    return device_loop.run(
        ("layered", g, nm, offset, cn, cn_impl, key, budget),
        lambda: make_layered_stepper(g, nm, offset, cn, cn_impl, syn=syn,
                                     nboper=nboper),
        intrinsic, max_iters)


def _compressed_stepper(g: DeviceGraph, nm: int, dtype, one_iteration):
    """(init_fn, step_fn) over the compressed state (app, cv_v, cv_g,
    cv_sat, decide, conv, iters), updated in place by ``one_iteration``."""
    e = g.n_edges

    def init_fn(intrinsic, state=None):
        if state is None:
            f, n, q = intrinsic.shape
            new = functools.partial(torch.empty, device=intrinsic.device)
            state = (new((f, n + 1, q), dtype=dtype),
                     new((f, e + 1, nm), dtype=dtype),
                     new((f, e + 1, nm), dtype=torch.uint8),
                     new((f, e + 1), dtype=dtype)
                     ) + decision_buffers(intrinsic)
        _, cv_v, cv_g, cv_sat = state[:4]
        cv_v.zero_()
        cv_g.copy_(torch.arange(nm, dtype=torch.uint8, device=cv_g.device))
        cv_sat.zero_()
        return _reset(g, state, intrinsic)

    def step_fn(state):
        app, cv_v, cv_g, cv_sat, decide, conv, iters = state
        active = ~conv
        one_iteration(app, cv_v, cv_g, cv_sat, active)
        return (app, cv_v, cv_g, cv_sat) + _step_decisions(
            g, app, decide, conv, iters, active)

    return init_fn, step_fn


def make_layered_compressed_stepper(g: DeviceGraph, nm: int,
                                    offset: float = 0.3,
                                    dtype=torch.bfloat16):
    """Layered EMS (dense ``fb_checknode_topk`` CN) with nm-compressed
    CtoV storage: ``state = init_fn(intrinsic)``, ``state =
    step_fn(state)``; state = (app, cv_v [F, E+1, nm], cv_g uint8,
    cv_sat [F, E+1], decide, conv, iters), updated in place.  After EMS
    output saturation a CN message has at most nm distinct sub-saturation
    values, so (vals, ids, sat) re-encodes it losslessly.  ``dtype`` is
    the storage dtype of APP and the CtoV values and saturation levels."""
    q = g.q
    rotated_cn = _make_rotated_cn(g, nm, "ems", "topk")

    def one_iteration(app, cv_v, cv_g, cv_sat, active):
        keep = ~active[:, None, None]                    # [F, 1, 1]
        for p in _layer_plan(g, str(app.device)):
            edge_ids, cols = p["edge_ids"], p["cols"]
            app_rows = app[:, cols]                      # [F, G, dc, q]
            cvv_rows = cv_v[:, edge_ids]
            cvg_rows = cv_g[:, edge_ids]
            sat_rows = cv_sat[:, edge_ids]
            ctov_rows = torch.minimum(
                scatter_topk_dense(cvv_rows, cvg_rows, q),
                sat_rows[..., None])
            mvc = app_rows - ctov_rows
            mvc = mvc - mvc.min(dim=-1, keepdim=True).values
            mcv = rotated_cn(mvc, p)
            # compress: nm best + saturation, a lossless re-encoding of the
            # EMS-saturated message (bubble_decoder.c:262-278)
            bv, bg = topk_message(mcv, nm)
            bv = bv - bv[..., 0:1]                       # normalize min=0
            sat = bv[..., -1] + offset
            dense = torch.minimum(scatter_topk_dense(bv, bg, q),
                                  sat[..., None])
            cv_v[:, edge_ids] = torch.where(keep[..., None], cvv_rows, bv)
            cv_g[:, edge_ids] = torch.where(keep[..., None], cvg_rows,
                                            bg.to(cv_g.dtype))
            cv_sat[:, edge_ids] = torch.where(keep, sat_rows, sat)
            app[:, cols] = torch.where(keep[..., None], app_rows,
                                       mvc + dense)

    return _compressed_stepper(g, nm, dtype, one_iteration)


def decode_layered_compressed(g, intrinsic, max_iters, nm, offset=0.3,
                              dtype=torch.bfloat16):
    """Returns (decide [F, N] int64, iters [F] int32, converged [F] bool)."""
    return host_loop(
        *make_layered_compressed_stepper(g, nm, offset, dtype),
        intrinsic, max_iters)


# ---------------------------------------------------------------------------
# truncated-list EMS (ops/listcn.py) with compressed CtoV storage: the
# bench's EMS row.  The CN is sorts and elementwise ops on [.., nm] lists.
# ---------------------------------------------------------------------------


def _make_list_iteration(g: DeviceGraph, nm: int, offset: float,
                         nboper: int):
    """One layered sweep over all super-layers, truncated-list EMS CN.

    State: dense APP [F, N+1, q] + compressed CtoV (vals [F, E+1, nm],
    ids [F, E+1, nm] uint8, sat [F, E+1]), the reference's own CtoV
    content (nm sorted entries + saturated fill, bubble_decoder.c:262-278).
    Returns ``one_iteration(app, cv_v, cv_g, cv_sat, active)``, which
    updates the four state tensors in place.
    """
    q = g.q
    # packed-key truncation quantizes to bf16 (the storage dtype); the
    # exact (nboper = 0) mode keeps the f32 sort for bit-exact oracle tests
    truncate = listcn.topk_list if nboper > 0 else topk_message

    def one_iteration(app, cv_v, cv_g, cv_sat, active):
        keep = ~active[:, None, None]                        # [F, 1, 1]
        for p in _layer_plan(g, str(app.device)):
            edge_ids, cols = p["edge_ids"], p["cols"]
            app_rows = app[:, cols]                          # [F, G, dc, q]
            cvv_rows = cv_v[:, edge_ids]
            cvg_rows = cv_g[:, edge_ids]
            sat_rows = cv_sat[:, edge_ids]
            ctov_rows = listcn.expand_list(
                cvv_rows.float(), cvg_rows, sat_rows.float(), q, app.dtype)
            mvc = app_rows - ctov_rows
            mvc = mvc - mvc.min(dim=-1, keepdim=True).values
            # VN truncation (NB_LDPC.c:354-374) + rotation of the id lists
            bv, bg = truncate(mvc.float(), nm)
            bgr = listcn.rotate_ids(bg.to(torch.int32), p["rc_in"][None])
            if p["valid"] is not None:
                nv, ng = listcn.neutral_list(bv.shape[:-1], nm,
                                             device=bv.device)
                lane = p["valid"][None, ..., None]
                bv = torch.where(lane, bv, nv)
                bgr = torch.where(lane, bgr, ng)
            ov, ogr = listcn.fb_checknode_list(bv, bgr, nm, nboper)
            og = listcn.rotate_ids(ogr, p["rc_out"][None])
            ov, sat = listcn.saturate_list(ov, offset)
            dense = listcn.expand_list(ov, og, sat, q, app.dtype)

            cv_v[:, edge_ids] = torch.where(keep[..., None], cvv_rows,
                                            ov.to(cv_v.dtype))
            cv_g[:, edge_ids] = torch.where(keep[..., None], cvg_rows,
                                            og.to(cv_g.dtype))
            cv_sat[:, edge_ids] = torch.where(keep, sat_rows,
                                              sat.to(cv_sat.dtype))
            app[:, cols] = torch.where(keep[..., None], app_rows,
                                       (mvc + dense).to(app.dtype))

    return one_iteration


def make_layered_list_stepper(g: DeviceGraph, nm: int, offset: float = 0.3,
                              nboper: int = 0, dtype=torch.bfloat16):
    """Host-loop list-EMS decoder: ``state = init_fn(intrinsic)``,
    ``state = step_fn(state)``; state = (app, cv_v, cv_g, cv_sat, decide,
    conv, iters), updated in place.  ``dtype`` is the storage dtype of
    APP and the CtoV values and saturation levels."""
    if not 1 <= nm <= g.q:
        raise ValueError(f"list EMS needs 1 <= nm <= q, got nm={nm}, "
                         f"q={g.q}")
    return _compressed_stepper(g, nm, dtype,
                               _make_list_iteration(g, nm, offset, nboper))


def decode_layered_list_hostloop(g, intrinsic, max_iters, nm, offset=0.3,
                                 nboper=0, dtype=torch.bfloat16):
    """Returns (decide [F, N] int64, iters [F] int32, converged [F] bool)."""
    return host_loop(
        *make_layered_list_stepper(g, nm, offset, nboper, dtype),
        intrinsic, max_iters)


def decode_layered_list(g, intrinsic, max_iters, nm, offset=0.3, nboper=0,
                        dtype=torch.bfloat16):
    """The JAX ``decode_layered_list`` (a ``while_loop``): the same decode as
    ``decode_layered_list_hostloop`` through ``device_loop``.  Returns
    (decide [F, N] int64, iters [F] int32, converged [F] bool)."""
    return device_loop.run(
        ("layered_list", g, nm, offset, nboper, dtype),
        lambda: make_layered_list_stepper(g, nm, offset, nboper, dtype),
        intrinsic, max_iters)
