"""Decoder front-end: configuration + dispatch.

``DecoderConfig`` has the JAX package's fields and defaults, so a
configuration carries across unchanged, and ``decode`` dispatches as the
JAX package's does.  Ported so far:

* both schedules (``"layered"``, ``"flooding"``) with dense float32 or
  bfloat16 storage and ``cn="ems"`` / ``"minsum"`` (``cn_impl`` pallas: the
  hand-written CUDA EMS check node K1 on the card; topk | auto | dense |
  list: the F/B check node ``use_topk`` picks, nm-truncated lists or the
  dense min-convolution, through K1 too wherever it takes the rows (dc >=
  3, shared memory: ``flooding.k1_route``), else in plain torch; bubble |
  lbubble: the exact 8-bubble / L-bubble emulation of the C reference's
  elementary step with the ``nboper`` budget (0: ``2 * nm``), its
  hand-written CUDA kernel on the card and its plain version on the CPU),
  ``cn="spa"`` (the hand-written CUDA SPA check node on the card) or
  ``cn="syndrome"`` (the syndrome-EMS check node with the ``syn_*``
  settings, as JAX's ``syn`` dict; the hand-written CUDA kernel on the
  card, its plain version on the CPU; it reads no ``cn_impl``, as in JAX);
* layered compressed storage, float32 or bfloat16: the dense-CN decoder
  for ``cn_impl="topk"`` (its F/B CN through K1's bare entry), the
  truncated-list EMS CN (K3 on the card, every ``nboper`` and nm) for any
  other value.

``loop="device"`` (the default) runs each decode as one replay of a
captured CUDA graph with on-device early exit on the card, and the same
schedule eagerly on the CPU (``device_loop``); ``loop="host"`` polls
convergence on the host once per step.  The compressed dense-CN decoder
(``cn_impl="topk"``) runs the host loop whatever ``loop`` says, as in JAX.

Dense bfloat16 storage (``dtype="bfloat16"``) holds the decoder state in
bf16: APP and CtoV (layered), the intrinsic and CtoV (flooding).  Every
step reads the state, widens it to f32 (exact), computes exactly what the
f32 path computes, and rounds once, to nearest even, where it writes the
state (``.to(torch.bfloat16)`` in torch, ``__float2bfloat16_rn`` in the
CUDA kernels); decisions are the argmin of the bf16 APP (layered) or of
the f32 totals (flooding).  The f32 path is unchanged (``x.float()`` of an
f32 tensor is ``x`` itself).  The JAX package holds the same state in bf16
but may round inside its steps, so the two agree on decisions of frames
both converge, not bit for bit.  Flooding ``cn="spa"`` at bf16 raises
``ValueError``: JAX's decode fails there (its while_loop carry changes
type).  As in JAX, compressed storage ignores ``cn`` and runs EMS,
``cn="syndrome"`` included.
"""
from __future__ import annotations

import dataclasses

import torch

from .flooding import decode_flooding, decode_flooding_hostloop
from ..utils.timing import span
from .graph import DeviceGraph
from .layered import (decode_layered, decode_layered_compressed,
                      decode_layered_hostloop, decode_layered_list,
                      decode_layered_list_hostloop)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    max_iters: int = 10
    schedule: str = "layered"   # "layered" | "flooding"
    cn: str = "ems"             # "minsum" (dense exact) | "ems" (nm-truncated)
    #                             | "spa" | "syndrome" (syn_* below)
    nm: int = 0                 # 0 -> no truncation (pure min-sum)
    offset: float = 0.3         # saturation offset (reference arg 6)
    nboper: int = 0             # elementary-step candidate budget (reference
    #                             arg 7); read by the list CN (0: its
    #                             exact top-nm merge) and the bubble CNs
    #                             (0 -> 2 * nm for these)
    cn_impl: str = "auto"       # dense | topk | list | pallas (the
    #                             hand-written CUDA CN, ops/cuda_cn.py) |
    #                             auto | bubble | lbubble (the exact bubble
    #                             emulation, ops/cuda_bubble.py);
    #                             cn="spa" and "syndrome" read none.
    #                             Compressed storage runs the dense-CN
    #                             decoder for topk, the list CN otherwise
    loop: str = "device"        # device (captured CUDA graph) | host
    storage: str = "dense"      # dense | compressed (nm-truncated CtoV,
    #                             layered only)
    syn_ncv: int = 45           # syndrome-CN parameters (cn="syndrome"):
    syn_d: tuple = (40, 15, 5)  # the reference main's setup (NB_LDPC.c:
    #                             188-200): n_cv, trapeze d1/d2/d3, the
    #                             1000-config cap, bayes, presorting
    syn_shape: str = "trapeze"
    syn_max_configs: int = 1000
    syn_bayes: bool = True
    syn_presort: bool = True
    syn_sat: str = "kth"
    dtype: str = "float32"

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def decode(code_or_graph, intrinsic: torch.Tensor, cfg: DecoderConfig):
    """intrinsic: [F, N, q] min-normalized cost tensor (on any device).

    Returns (decide [F, N] int64, iters [F] int32, converged [F] bool), on
    the intrinsic's device.
    """
    if cfg.loop not in ("device", "host"):
        raise ValueError(f"loop={cfg.loop!r}: expected 'device' or 'host'")
    if cfg.storage not in ("dense", "compressed"):
        raise ValueError(
            f"storage={cfg.storage!r}: expected 'dense' or 'compressed'")
    if cfg.schedule not in ("layered", "flooding"):
        raise ValueError(cfg.schedule)
    if cfg.schedule == "flooding" and cfg.storage == "compressed":
        raise ValueError(
            "compressed storage is implemented for the layered schedule "
            "(the big-code path); use schedule='layered'")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype={cfg.dtype!r}")
    if (cfg.storage == "dense" and cfg.schedule == "flooding"
            and cfg.cn == "spa" and cfg.dtype != "float32"):
        raise ValueError(
            f"dtype={cfg.dtype!r}: flooding SPA runs at float32 only; the "
            "JAX package's decode fails there too (its fused SPA CN returns "
            "f32 into the bf16 while_loop carry: a TypeError)")
    with span("decode"):
        g = (code_or_graph if isinstance(code_or_graph, DeviceGraph)
             else DeviceGraph.from_code(code_or_graph))
        intrinsic = intrinsic.to(cfg.torch_dtype())
        on_device = cfg.loop == "device"
        if cfg.storage == "compressed":
            if cfg.cn_impl == "topk":
                return decode_layered_compressed(
                    g, intrinsic, cfg.max_iters, nm=cfg.nm,
                    offset=cfg.offset, dtype=cfg.torch_dtype())
            run = (decode_layered_list if on_device
                   else decode_layered_list_hostloop)
            return run(g, intrinsic, cfg.max_iters, nm=cfg.nm,
                       offset=cfg.offset, nboper=cfg.nboper,
                       dtype=cfg.torch_dtype())
        syn = None
        if cfg.cn == "syndrome":
            syn = dict(
                n_cv=cfg.syn_ncv, d1=cfg.syn_d[0], d2=cfg.syn_d[1],
                d3=cfg.syn_d[2], shape=cfg.syn_shape,
                max_configs=cfg.syn_max_configs, use_bayes=cfg.syn_bayes,
                presort=cfg.syn_presort, sat_rule=cfg.syn_sat)
        if cfg.schedule == "flooding":
            run = decode_flooding if on_device else decode_flooding_hostloop
        else:
            run = decode_layered if on_device else decode_layered_hostloop
        return run(g, intrinsic, cfg.max_iters, nm=cfg.nm,
                   offset=cfg.offset, cn=cfg.cn, cn_impl=cfg.cn_impl,
                   syn=syn, nboper=cfg.nboper)
