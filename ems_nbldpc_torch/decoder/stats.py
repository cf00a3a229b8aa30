"""Decoder observability: iteration/convergence traces and candidate-rank
histograms.

Port of ``ems_nbldpc_tpu/decoder/stats.py``.  The reference carries a
dormant ``stat_bubble`` array that histograms which bubble position
produced each elementary-step output (``NB_LDPC.c:159-164,517-556``).
Here, in the truncated combine ``out[s] = min_j Bv[j] + A[s ^ Bg[j]]``,
the histogram counts which *rank* ``j`` of the truncated side won each
output symbol: it tells how big ``nm`` really needs to be.  Also a
per-iteration convergence trace (frames converged after each iteration),
the batched analog of the reference's per-frame progress line
(``NB_LDPC.c:498-500``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.minconv import delta_message, ems_input_truncate, topk_message
from .flooding import (_edge_rotations, _rows_from_edges, _vn_totals,
                       check_supported, checknode, syndrome_ok)
from .graph import DeviceGraph, rotate, upload

# the histogram pass's temporaries per candidate: the int64 gather index,
# the gathered f32 values and the f32 candidates, with room for argmin's
HIST_ENTRY_BYTES = 20
HIST_BUDGET_BYTES = 2**31      # frames are taken in chunks within this


@dataclasses.dataclass
class DecodeStats:
    conv_by_iter: np.ndarray      # [max_iters+1] frames converged after i
    iters: np.ndarray             # [F]
    rank_hist: np.ndarray         # [nm] winner-rank histogram (last iter)
    avg_iters: float


def hist_chunk(g: DeviceGraph, nm: int) -> int:
    """Frames per chunk of ``winner_rank_histogram``: the most whose
    [frames, M, nm, q] candidates fit ``HIST_BUDGET_BYTES``."""
    per_frame = g.code.m_rows * nm * g.q * HIST_ENTRY_BYTES
    return max(1, HIST_BUDGET_BYTES // per_frame)


def winner_rank_histogram(g: DeviceGraph, vtoc, nm: int,
                          frames_per_chunk: int | None = None):
    """One CN pass recording arg-min ranks (the forward sweep only, as
    representative of all elementary steps).  vtoc: [F, E, q] normalized.
    Returns the [nm] int64 histogram on vtoc's device.

    The frames go through in chunks of ``frames_per_chunk`` (default
    ``hist_chunk``): every frame's counts are its own, so the chunking
    changes no count.  A tie keeps the first (lowest) rank, as
    ``jnp.argmin`` does; truncated entries all cost ``INF``, so ties are
    common."""
    q, dev = g.q, vtoc.device
    f = vtoc.shape[0]
    chunk = frames_per_chunk or hist_chunk(g, nm)
    rot_in, _ = _edge_rotations(g, str(dev))
    s = torch.arange(q, device=dev)
    hist = torch.zeros(nm, dtype=torch.int64, device=dev)
    for f0 in range(0, f, chunk):
        vr = rotate(ems_input_truncate(vtoc[f0:f0 + chunk], nm), rot_in)
        pad = delta_message((vr.shape[0], 1), q, vr.dtype, dev)
        vr_rows = _rows_from_edges(g, torch.cat([vr, pad], dim=1))
        del vr
        bv, bg = topk_message(vr_rows, nm)
        acc = vr_rows[..., 0, :]
        for i in range(1, vr_rows.shape[-2]):
            idx = bg[..., i, :, None] ^ s                 # [Fc, M, nm, q]
            ax = torch.gather(acc[..., None, :].expand(idx.shape), -1, idx)
            del idx
            cand = bv[..., i, :, None] + ax
            del ax
            ranks = cand.argmin(dim=-2)                   # [Fc, M, q]
            hist += torch.bincount(ranks.reshape(-1), minlength=nm)
            acc = cand.amin(dim=-2)
            del cand, ranks
    return hist


def decode_flooding_stats(
    g: DeviceGraph, intrinsic, max_iters: int, nm: int = 0,
    offset: float = 0.0, cn: str = "minsum", cn_impl: str = "auto",
) -> DecodeStats:
    """Like ``decode_flooding`` but host-stepped (one host read of the
    convergence flags a step), returning ``DecodeStats``.  The CN is
    ``flooding.checknode`` with no ``syn`` and no ``nboper``, as in JAX:
    ``cn_impl="pallas"`` launches the CUDA EMS check node once a step on
    the card."""
    f, n, q = intrinsic.shape
    e = g.n_edges
    nm_eff = nm if 0 < nm < q else min(q, 32)
    check_supported(nm, q, cn, cn_impl, None, g.code.dc_max)
    edge_col = upload(g, str(intrinsic.device))["edge_col"]
    ctov_pad = intrinsic.new_zeros((f, e + 1, q))

    def step(conv):
        """One flooding step on ``ctov_pad`` (in place); returns the new
        convergence flags and the step's normalized VtoC."""
        tot = _vn_totals(g, intrinsic, ctov_pad)
        vtoc = tot[:, edge_col] - ctov_pad[:, :e]
        del tot
        vtoc = vtoc - vtoc.min(dim=-1, keepdim=True).values
        mcv = checknode(g, vtoc, nm, offset, cn, cn_impl)
        active = ~conv
        ctov_pad[:, :e] = torch.where(active[:, None, None], mcv,
                                      ctov_pad[:, :e])
        del mcv
        decide = _vn_totals(g, intrinsic, ctov_pad).argmin(dim=-1)
        return conv | syndrome_ok(g, decide), vtoc

    conv = syndrome_ok(g, intrinsic.argmin(dim=-1))
    conv_trace = [int(conv.sum())]
    iters = torch.zeros(f, dtype=torch.int32, device=intrinsic.device)
    last_vtoc = None
    for _ in range(max_iters):
        if bool(conv.all()):
            break
        iters = iters + (~conv).to(torch.int32)
        last_vtoc = None                    # free it before the step
        conv, last_vtoc = step(conv)
        conv_trace.append(int(conv.sum()))
    if last_vtoc is not None:
        hist = winner_rank_histogram(g, last_vtoc, nm_eff).cpu().numpy()
    else:
        hist = np.zeros(nm_eff, np.int64)
    iters_np = iters.cpu().numpy()
    trace = np.asarray(conv_trace
                       + [conv_trace[-1]] * (max_iters + 1 - len(conv_trace)))
    return DecodeStats(conv_by_iter=trace, iters=iters_np, rank_hist=hist,
                       avg_iters=float(iters_np.mean()))
