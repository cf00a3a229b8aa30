"""Layered min-sum decoding over GF(q), in float32 (EMS with nm = q: no
truncation, the exact min-sum of Wymeersch, Steendam and Moeneclaey, ICC
2004, and of Declercq and Fossorier, IEEE Trans. Commun. 55(4), 2007).

The state is a dense APP [F, N + 1, q] and a dense CtoV [F, E + 1, q] of
costs (a cost is -log of a probability, less the vector's minimum), both
float32.  Per super-layer and active frame:

* mvc = APP[cols] - CtoV[edges], less its minimum;
* each slot's vector rotates by its row coefficient h: the check sees the
  cost of h x where the variable has that of x (vr[u] = mvc[h^-1 u]); a
  padded slot (coefficient 0) becomes the delta message (0 at GF 0, INF
  elsewhere), which adds nothing to a merge;
* the forward / backward chains of exact min-convolutions over GF(q)
  addition (XOR), with all q entries: (a * b)[z] = min_x a[x] + b[x ^ z];
  slot 0 takes the backward chain of slots 1 .. dc-1, the last slot the
  forward chain of slots 0 .. dc-2, a middle slot i the merge of the
  forward chain to i-1 with the backward chain from i+1; dc = 2 swaps the
  pair, dc = 1 gives the delta message;
* each output rotates back (out[x] = out_r[h x]) and is normalised to a
  minimum of 0;
* CtoV[edges] = the output, APP[cols] = mvc + the output.

Departures from the published decoders, each as the port computes them:

* no offset and no saturation: the configuration's ``offset`` is read
  only where EMS truncates to nm < q entries (it then offsets the
  saturation level of the unlisted entries); at nm = 0 (or q) every entry
  is kept, so there is nothing to saturate, and the outputs are the exact
  min-convolutions;
* a frame stops at the first iteration after which the argmin of its APP
  meets every check (``layered.decode``), its state frozen from then on;
* every candidate sum is one float32 add and the minimum is exact, so an
  output does not depend on the order the candidates are visited in; it
  does depend on how the chains associate, and the chains are the ones
  above.

The control (``control=True``) stores APP and CtoV in bfloat16 (rounded to
nearest even where written), one precision step below float32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import layered

INF = 1e9
ROWS = 2048          # rows of a [ROWS, q, q] candidate block (512 MB at 256)


def minconv(a: torch.Tensor, b: torch.Tensor, xor: torch.Tensor):
    """[..., q] x [..., q] -> [..., q]: out[z] = min_x a[x] + b[x ^ z]
    (``xor``: the [q, q] table x ^ z), in blocks of ``ROWS`` rows."""
    q = a.shape[-1]
    a2, b2 = a.reshape(-1, q), b.reshape(-1, q)
    out = torch.empty_like(a2)
    for i in range(0, a2.shape[0], ROWS):
        cand = a2[i:i + ROWS, :, None] + b2[i:i + ROWS][:, xor]
        out[i:i + ROWS] = cand.amin(dim=1)
    return out.reshape(a.shape)


def delta(q: int, device) -> torch.Tensor:
    """The delta message [q]: cost 0 at GF 0, INF elsewhere."""
    d = torch.full((q,), INF, device=device)
    d[0] = 0.0
    return d


def checknode(vr: torch.Tensor, xor: torch.Tensor) -> torch.Tensor:
    """Forward / backward chains over [..., dc, q] rotated vectors."""
    dc, q = vr.shape[-2:]
    if dc == 1:
        return delta(q, vr.device).expand(vr.shape).clone()
    if dc == 2:
        return vr.flip(-2)
    fwd, bwd = [vr[..., 0, :]], [vr[..., dc - 1, :]]
    for i in range(1, dc - 1):
        both = minconv(torch.stack([fwd[-1], bwd[-1]]),
                       torch.stack([vr[..., i, :], vr[..., dc - 1 - i, :]]),
                       xor)
        fwd.append(both[0])
        bwd.append(both[1])
    bwd = bwd[::-1]                      # bwd[j]: the merge of slots j+1 ..
    mid = minconv(torch.stack(fwd[:dc - 2], dim=-2),
                  torch.stack(bwd[1:dc - 1], dim=-2), xor)
    outs = [bwd[0]] + [mid[..., i, :] for i in range(dc - 2)] + [fwd[-1]]
    return torch.stack(outs, dim=-2)


def _plans(code, device):
    gf, q = code.gf, code.q
    plans = []
    for rows in code.layers:
        coefs = code.row_coefs[rows]
        h = np.where(coefs == 0, 1, coefs)
        plans.append(dict(
            cols=torch.as_tensor(code.row_cols[rows], device=device),
            edges=torch.as_tensor(code.row_edges[rows], device=device),
            rot_in=torch.as_tensor(gf.mul_table[gf.inv(h)], device=device),
            rot_out=torch.as_tensor(gf.mul_table[h], device=device),
            pad=torch.as_tensor(coefs == 0, device=device)))
    return plans


def _rotate(x, table):
    return torch.gather(x, -1, table.expand(x.shape))


def decode(code, intr: torch.Tensor, dec: dict, control: bool = False,
           block: int = 32):
    """Decode ``intr`` [F, N, q] float32 under the configuration's decoder
    settings ``dec``, ``block`` frames at a time; returns (decisions,
    iterations, converged)."""
    q = code.q
    if (dec["cn"] not in ("ems", "minsum") or dec["nm"] not in (0, q)
            or dec["storage"] != "dense" or dec["dtype"] != "float32"
            or dec["cn_impl"] in ("bubble", "lbubble")):
        raise ValueError(f"the min-sum reference decodes dense float32 "
                         f"EMS / min-sum at nm = 0 or q: {dec}")
    dev, n = intr.device, code.n
    plans = _plans(code, dev)
    s = torch.arange(q, device=dev)
    xor = s[:, None] ^ s[None, :]
    neutral = delta(q, dev)

    def store(x):
        return x.to(torch.bfloat16).float() if control else x

    def one(x):
        f = x.shape[0]
        app = torch.zeros((f, n + 1, q), device=dev)
        app[:, :n] = store(x)
        ctov = torch.zeros((f, code.n_edges + 1, q), device=dev)

        def sweep(active):
            idx = torch.nonzero(active).squeeze(1)
            a, c = app[idx], ctov[idx]         # the active frames only
            for p in plans:
                mvc = a[:, p["cols"]] - c[:, p["edges"]]
                mvc = mvc - mvc.min(dim=-1, keepdim=True).values
                vr = _rotate(mvc, p["rot_in"])
                vr = torch.where(p["pad"][..., None], neutral, vr)
                out = _rotate(checknode(vr, xor), p["rot_out"])
                out = out - out.min(dim=-1, keepdim=True).values
                c[:, p["edges"]] = store(out)
                a[:, p["cols"]] = store(mvc + out)
            app[idx], ctov[idx] = a, c

        return layered.decode(code, app, sweep, dec["max_iters"])

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return layered.in_blocks(one, intr, block)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

