"""BER/FER snapshots at multiple iteration budgets in one decode pass.

Port of ``ems_nbldpc_tpu/sim/snapshots.py``.  The v2 standalone reference
decoder reports BER for iteration budgets 10/20/30/40/50 from a single
simulation (``EMS_HS_L-BubbleCheck_UBS_decoder_v2.c:2174-2307``).  Here:
run the host-stepped layered stepper once up to ``max(budgets)``
iterations and record the error counters at each budget: one decode, a
whole iteration-budget sweep.  Batch ``b`` is the batch ``MonteCarlo.run``
draws for the same seed (``MonteCarlo.gen``), counted as it counts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..decoder.layered import make_layered_stepper
from ..models.code import NBCode
from ..models.encoder import Encoder
from .mc import MonteCarlo, SimConfig


@dataclasses.dataclass
class SnapshotResult:
    budgets: list
    frames: int
    frame_errors: dict      # budget -> count
    bit_errors: dict        # budget -> count

    def fer(self, budget):
        return self.frame_errors[budget] / max(self.frames, 1)

    def ber(self, budget, k_bits):
        return self.bit_errors[budget] / max(self.frames * k_bits, 1)


def snapshot_batch(init_fn, step_fn, intrinsic, cw, budgets, count):
    """Step one batch up to each budget in turn, stopping early once every
    frame has converged (one host read of the flags a step), and count its
    errors there.  ``count(decide, cw, iters, conv)`` returns
    ``MonteCarlo.count``'s (counters, frame flags).  Returns ({budget:
    frame errors}, {budget: bit errors})."""
    state = init_fn(intrinsic)
    it = 0
    fe, be = {}, {}
    for b in sorted(budgets):
        while it < b and not bool(state[-2].all()):
            state = step_fn(state)
            it += 1
        counters, _ = count(state[-3], cw, state[-1], state[-2])
        fe[b], be[b] = counters[1:3].tolist()
    return fe, be


def run_snapshots(code: NBCode, cfg: SimConfig, budgets=(10, 20, 30, 40, 50),
                  batches: int = 1, *, device,
                  enc: Optional[Encoder] = None) -> SnapshotResult:
    """Frame and bit errors of ``batches`` batches at each budget.  The
    stepper is ``make_layered_stepper`` with the decoder's nm, offset, cn
    and cn_impl only (no ``syn``, no ``nboper``; the schedule is layered
    and the state f32 whatever ``cfg.decoder`` says), as in JAX.  ``enc``
    reuses an encoder (``MonteCarlo``'s)."""
    mc = MonteCarlo(code, cfg, enc, device=device)
    d = cfg.decoder
    init_fn, step_fn = make_layered_stepper(mc.graph, nm=d.nm,
                                            offset=d.offset, cn=d.cn,
                                            cn_impl=d.cn_impl)
    budgets = sorted(budgets)
    frames = 0
    fe = {b: 0 for b in budgets}
    be = {b: 0 for b in budgets}
    for bidx in range(batches):
        cw, intr = mc.gen(bidx)
        f_err, b_err = snapshot_batch(init_fn, step_fn, intr, cw, budgets,
                                      mc.count)
        frames += cfg.frames_per_batch
        for b in budgets:
            fe[b] += f_err[b]
            be[b] += b_err[b]
    return SnapshotResult(budgets=list(budgets), frames=frames,
                          frame_errors=fe, bit_errors=be)
