"""Decoder front-end: configuration + dispatch.

``DecoderConfig`` has the JAX package's fields and defaults, so a
configuration carries across unchanged.  Ported so far, all on the layered
schedule with the host loop:

* dense float32 storage with ``cn="ems"`` (``cn_impl`` topk | pallas |
  auto) or ``cn="spa"`` (the hand-written CUDA SPA check node on the card);
* compressed storage with the truncated-list EMS CN (any ``cn_impl`` but
  ``"topk"``, as in the JAX package), float32 or bfloat16.

Every other branch raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import torch

from .graph import DeviceGraph
from .layered import decode_layered_hostloop, decode_layered_list_hostloop


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    max_iters: int = 10
    schedule: str = "layered"   # "layered" | "flooding"
    cn: str = "ems"             # "minsum" (dense exact) | "ems" (nm-truncated)
    nm: int = 0                 # 0 -> no truncation (pure min-sum)
    offset: float = 0.3         # saturation offset (reference arg 6)
    nboper: int = 0             # elementary-step candidate budget (reference
    #                             arg 7); read by the list CN only
    cn_impl: str = "auto"       # topk | pallas (the hand-written CUDA CN,
    #                             ops/cuda_cn.py) | auto; dense | list |
    #                             bubble | lbubble are not ported yet.
    #                             Compressed storage runs the list CN for
    #                             any value but topk (not ported yet)
    loop: str = "device"        # device (not ported yet) | host
    storage: str = "dense"      # dense | compressed (nm-truncated CtoV)
    syn_ncv: int = 45           # syndrome-CN family parameters (cn=
    syn_d: tuple = (40, 15, 5)  # "syndrome", not ported yet)
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
    if cfg.schedule == "flooding":
        raise NotImplementedError(
            "schedule='flooding' is not ported yet (ROADMAP Queue 1: "
            "flooding and the min-conv CNs)")
    if cfg.loop == "device":
        raise NotImplementedError(
            "loop='device' is not ported yet (ROADMAP Queue 1: device "
            "loops); use loop='host'")
    if cfg.storage == "compressed" and cfg.cn_impl == "topk":
        raise NotImplementedError(
            "storage='compressed' with cn_impl='topk' (the dense-CN "
            "compressed decoder) is not ported yet (ROADMAP Queue 1: "
            "flooding and the min-conv CNs)")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype={cfg.dtype!r}")
    if cfg.storage == "dense" and cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r}: the dense path is ported for float32 "
            "only (ROADMAP Queue 1: flooding and the min-conv CNs, dense "
            "bf16 storage)")
    g = (code_or_graph if isinstance(code_or_graph, DeviceGraph)
         else DeviceGraph.from_code(code_or_graph))
    intrinsic = intrinsic.to(cfg.torch_dtype())
    if cfg.storage == "compressed":
        return decode_layered_list_hostloop(
            g, intrinsic, cfg.max_iters, nm=cfg.nm, offset=cfg.offset,
            nboper=cfg.nboper, dtype=cfg.torch_dtype())
    return decode_layered_hostloop(
        g, intrinsic, cfg.max_iters, nm=cfg.nm, offset=cfg.offset,
        cn=cfg.cn, cn_impl=cfg.cn_impl)
