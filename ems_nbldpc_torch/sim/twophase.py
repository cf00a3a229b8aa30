"""Two-phase Monte-Carlo decoding: cheap first pass, compacted retry.

Port of ``ems_nbldpc_tpu/sim/twophase.py``.  At operating SNRs most
frames converge in 1-3 iterations, but a lockstep batch pays for its
slowest frame (SURVEY.md §7.3 hard part 2).  Phase A decodes the full
batch with a small iteration budget; the few unconverged frames are
gathered on the device into a fixed-size retry batch that gets the full
budget.  Phase B restarts from the intrinsic, and a frame that phase A
converged went through the same first iterations, so the counters equal
``MonteCarlo.run``'s for the same configuration and seed.

Under the device loop each phase is one loop key (batch F at phase A's
budget, then batch ``cap`` at the full one): a run captures two graphs,
which ``device_loop.MAX_CACHED`` keeps.  Only the convergence flags of
phase A are read on the host, to find the frames to retry.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..decoder.api import decode
from ..models.code import NBCode
from ..models.encoder import Encoder
from .mc import MonteCarlo, SimConfig, SimResult


def make_twophase(code: NBCode, cfg: SimConfig, phase_a_iters: int = 3,
                  retry_frac: int = 4, *, device,
                  enc: Optional[Encoder] = None):
    """Returns ``run_batch(batch_idx)`` -> ``MonteCarlo.count``'s counters
    [6] (int64, on ``device``), whose decoder steps are phase A's steps
    plus every retry's.  ``enc`` reuses an encoder."""
    mc = MonteCarlo(code, cfg, enc, device=device)
    cap = max(8, cfg.frames_per_batch // retry_frac)
    cfg_b = cfg.decoder
    cfg_a = dataclasses.replace(cfg_b, max_iters=phase_a_iters)

    def run_batch(batch_idx: int) -> torch.Tensor:
        cw, intr = mc.gen(batch_idx)
        decide, iters, conv = decode(mc.graph, intr, cfg_a)
        steps = iters.max().to(torch.int64)
        bad = torch.nonzero(~conv).flatten()
        for start in range(0, len(bad), cap):
            idx = bad[start:start + cap]
            pad = torch.cat([idx, idx.new_zeros(cap - len(idx))])
            d2, it2, c2 = decode(mc.graph, intr[pad], cfg_b)
            sel = slice(0, len(idx))
            decide[idx], iters[idx], conv[idx] = d2[sel], it2[sel], c2[sel]
            steps = steps + it2.max()
        counters, _ = mc.count(decide, cw, iters, conv)
        counters[5] = steps
        return counters

    return run_batch


def run_twophase(code: NBCode, cfg: SimConfig, phase_a_iters: int = 3,
                 verbose: bool = False, *, device,
                 enc: Optional[Encoder] = None) -> SimResult:
    """``MonteCarlo.run``'s loop and stop rule over ``make_twophase``'s
    batches."""
    run_batch = make_twophase(code, cfg, phase_a_iters, device=device,
                              enc=enc)
    totals = np.zeros(6, dtype=np.int64)
    t0 = time.perf_counter()
    b = 0
    while totals[0] < cfg.max_frames and totals[1] < cfg.stop_errors:
        totals += run_batch(b).cpu().numpy()
        b += 1
        if verbose:
            print(f"\rFER={totals[1]}/{totals[0]}", end="", flush=True)
    if verbose:
        print()
    return SimResult(
        frames=int(totals[0]), frame_errors=int(totals[1]),
        bit_errors=int(totals[2]), undetected_errors=int(totals[3]),
        iter_sum=int(totals[4]), elapsed_s=time.perf_counter() - t0,
        config=cfg, code_name=code.name, n=code.n, k=code.k, logq=code.logq,
        decoder_steps=int(totals[5]),
    )
