"""The layered schedule's loop, shared by the decoder families.

Each iteration sweeps the super-layers in order; after it, an active
frame (one that has not met every check yet) takes the argmin of its APP
as its decisions, and a frame whose decisions meet every check stops:
its state, decisions and iteration count are frozen from then on.  The
loop ends when every frame has stopped or after ``max_iters`` sweeps, so a
frame that never meets the checks reports ``max_iters`` iterations.
Frames do not interact, so a batch may be decoded in blocks of frames.
"""
from __future__ import annotations

import torch


def decode(code, app: torch.Tensor, sweep, max_iters: int):
    """``app``: [F, N + 1, q] initial APP (the padding column last);
    ``sweep(active)`` runs one iteration in place on the family's state.
    Returns (decisions [F, N] int64, iterations [F] int32, converged [F]
    bool)."""
    n = code.n
    decide = app[:, :n].argmin(dim=-1)
    conv = code.syndrome_ok(decide)
    iters = torch.zeros(app.shape[0], dtype=torch.int32, device=app.device)
    for _ in range(max_iters):
        if bool(conv.all()):
            break
        active = ~conv
        sweep(active)
        decide = torch.where(active[:, None], app[:, :n].argmin(dim=-1),
                             decide)
        conv = conv | code.syndrome_ok(decide)
        iters = iters + active.to(torch.int32)
    return decide, iters, conv


def in_blocks(decode_block, intr: torch.Tensor, block: int):
    """Decode ``intr`` [F, N, q] ``block`` frames at a time."""
    outs = [decode_block(intr[i:i + block])
            for i in range(0, intr.shape[0], block)]
    return tuple(torch.cat(parts) for parts in zip(*outs))
