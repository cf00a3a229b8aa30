"""Layered (horizontal) schedule over column-disjoint super-layers.

Port of the dense-storage EMS path of ``ems_nbldpc_tpu/decoder/layered.py``
(``_layer_plan``, ``_make_dense_iteration``, ``make_layered_stepper``,
``decode_layered_hostloop``).  Rows that share no variable commute, so each
super-layer (host colouring, ``models/code.py``) is one batched CN step.

State: APP [F, N+1, q] and CtoV [F, E+1, q], each with the JAX package's
padding column / edge (the target of padded row slots).  The JAX
version's functional ``.at[].set`` scatters become in-place indexed
assignment on these two tensors: a super-layer's columns and edges are
disjoint, so every written element has one writer.

Per super-layer (the reference's ``NB_LDPC.c:320-466``):
  mvc  = APP[cols] - CtoV[edges]      (VN extrinsic), minus its min
  mcv  = CN(rotate(truncate(mvc)))    (nm-truncated F/B EMS)
  mcv  = saturate(rotate_back(mcv)), minus its min
  CtoV[edges] = mcv,  APP[cols] = mvc + mcv   (frozen frames keep theirs)
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.cuda_cn import fb_checknode
from ..ops.minconv import (delta_message, ems_input_truncate,
                           ems_output_saturate, fb_checknode_topk)
from .flooding import syndrome_ok, use_topk
from .graph import DeviceGraph, rotate, rotation_table


@functools.lru_cache(maxsize=16)
def _layer_plan(g: DeviceGraph, device: str):
    """Per-layer index tensors and rotation tables on ``device``."""
    e = g.n_edges
    n = g.code.n
    dc = g.code.dc_max

    def up(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    plans = []
    for rows in g.layers:
        rows = np.asarray(rows)
        edge_ids = g.row_edges[rows]
        cols = np.concatenate([g.code.row_cols, np.full((1, dc), n)])[rows]
        valid = edge_ids < e
        coefs = g.code.row_coefs[rows]
        plans.append(dict(
            edge_ids=up(edge_ids),
            cols=up(cols),
            # None for full rows: the neutral-message mask is then a no-op
            valid=None if valid.all() else torch.as_tensor(valid, device=device),
            rot_in=up(rotation_table(coefs, g.code.gf, "in")),
            rot_out=up(rotation_table(coefs, g.code.gf, "out")),
            shape=(len(rows), dc),
        ))
    return plans


def _check_supported(nm, q, cn, cn_impl):
    if cn != "ems":
        raise NotImplementedError(
            f"cn={cn!r} is not ported yet (ROADMAP Queue 1: the SPA path, "
            "the syndrome CN, and the dense min-sum CN)")
    if cn_impl in ("bubble", "lbubble", "list"):
        raise NotImplementedError(
            f"cn_impl={cn_impl!r} is not ported yet (ROADMAP Queue 1)")
    if cn_impl not in ("pallas", "topk", "auto", "dense"):
        raise ValueError(f"cn_impl={cn_impl!r}")
    if cn_impl != "pallas" and not use_topk(cn, nm, q, cn_impl):
        raise NotImplementedError(
            f"nm={nm}, q={q}, cn_impl={cn_impl!r} selects the dense CN, "
            "which is not ported yet (ROADMAP Queue 1: the min-conv CNs)")
    if not 1 <= nm <= q:
        raise ValueError(f"cn='ems' needs 1 <= nm <= q, got nm={nm}, q={q}")


def _make_dense_iteration(g: DeviceGraph, nm, offset, cn, cn_impl):
    """The per-iteration CN sweep over all super-layers.

    Returns ``one_iteration(app, ctov, active)``, which updates ``app`` and
    ``ctov`` in place.  ``cn_impl="pallas"`` runs the hand-written CUDA
    check node (``ops/cuda_cn.fb_checknode``; its plain version on CPU
    tensors); ``"topk"``/``"auto"`` the plain torch ``fb_checknode_topk``.
    """
    q = g.q
    _check_supported(nm, q, cn, cn_impl)
    truncate = nm < q

    def one_iteration(app, ctov, active):
        f = app.shape[0]
        act = active[:, None, None, None]
        for p in _layer_plan(g, str(app.device)):
            gdim, dcdim = p["shape"]
            app_rows = app[:, p["cols"]]                 # [F, G, dc, q]
            ctov_rows = ctov[:, p["edge_ids"]]
            mvc = app_rows - ctov_rows
            mvc = mvc - mvc.min(dim=-1, keepdim=True).values
            mvc_cn = ems_input_truncate(mvc, nm) if truncate else mvc
            vr = rotate(mvc_cn.reshape(f, gdim * dcdim, q), p["rot_in"])
            vr = vr.reshape(mvc.shape)
            if p["valid"] is not None:
                neutral = delta_message(vr.shape[:-1], q, vr.dtype, vr.device)
                vr = torch.where(p["valid"][None, ..., None], vr, neutral)
            if cn_impl == "pallas":
                mcv_r = fb_checknode(vr.reshape(f * gdim, dcdim, q), nm)
            else:
                mcv_r = fb_checknode_topk(vr, nm)
            mcv = rotate(mcv_r.reshape(f, gdim * dcdim, q), p["rot_out"])
            mcv = mcv.reshape(mvc.shape)
            if truncate:
                mcv = ems_output_saturate(mcv, nm, offset)
            mcv = mcv - mcv.min(dim=-1, keepdim=True).values
            # freeze converged frames (their APP/CtoV stop changing)
            mcv = torch.where(act, mcv, ctov_rows)
            new_app = torch.where(act, mvc + mcv, app_rows)
            ctov[:, p["edge_ids"]] = mcv
            app[:, p["cols"]] = new_app

    return one_iteration


def make_layered_stepper(
    g: DeviceGraph,
    nm: int = 0,
    offset: float = 0.0,
    cn: str = "minsum",
    cn_impl: str = "auto",
):
    """Host-loop decoder: ``state = init_fn(intrinsic)``,
    ``state = step_fn(state)``; state = (app, ctov, decide, conv, iters).
    ``step_fn`` updates app and ctov in place and returns the new state.
    """
    n, q, e = g.code.n, g.q, g.n_edges
    one_iteration = _make_dense_iteration(g, nm, offset, cn, cn_impl)

    def init_fn(intrinsic):
        f = intrinsic.shape[0]
        app0 = torch.nn.functional.pad(intrinsic, (0, 0, 0, 1))
        ctov0 = torch.zeros((f, e + 1, q), dtype=intrinsic.dtype,
                            device=intrinsic.device)
        d0 = app0[:, :n].argmin(dim=-1)
        conv0 = syndrome_ok(g, d0)
        iters0 = torch.zeros(f, dtype=torch.int32, device=intrinsic.device)
        return app0, ctov0, d0, conv0, iters0

    def step_fn(state):
        app, ctov, decide, conv, iters = state
        active = ~conv
        one_iteration(app, ctov, active)
        d_new = app[:, :n].argmin(dim=-1)
        decide = torch.where(active[:, None], d_new, decide)
        conv = conv | syndrome_ok(g, decide)
        iters = iters + active.to(torch.int32)
        return app, ctov, decide, conv, iters

    return init_fn, step_fn


def decode_layered_hostloop(g, intrinsic, max_iters, nm=0, offset=0.0,
                            cn="minsum", cn_impl="auto"):
    """Returns (decide [F, N] int64, iters [F] int32, converged [F] bool).

    Polls ``conv.all()`` on the host once per iteration and stops when
    every frame has converged or the budget is spent.
    """
    init_fn, step_fn = make_layered_stepper(g, nm, offset, cn, cn_impl)
    state = init_fn(intrinsic)
    for _ in range(max_iters):
        if bool(state[3].all()):
            break
        state = step_fn(state)
    _, _, decide, conv, iters = state
    return decide, iters, conv
