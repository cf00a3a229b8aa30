"""Syndrome check and CN-implementation choice shared by the schedules.

The slice of ``ems_nbldpc_tpu/decoder/flooding.py`` that the layered
decoder uses.  The flooding schedule itself is not ported yet.
"""
from __future__ import annotations

import torch

from .graph import DeviceGraph, upload


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
