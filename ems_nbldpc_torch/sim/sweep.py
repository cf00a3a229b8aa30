"""Eb/N0 sweeps + result files.

Port of ``ems_nbldpc_tpu/sim/sweep.py``: an in-process sweep in place of
the reference's one forked process per SNR point (``start.sh``), with the
reference's result-file append (``NB_LDPC.c:136,568-579``) as a text file
in the same spirit and as structured JSONL, in the JAX package's formats.
One ``MonteCarlo`` serves the sweep: Eb/N0 enters only the channel, so
one device loop (one captured graph) serves every point.  On a mesh
(``parallel/mesh``) one sharded step serves the sweep; rank 0 reads the
resume set and hands it to every rank, and alone prints and writes the
result files.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterable, Optional

from ..models.code import NBCode
from .mc import MonteCarlo, SimConfig, SimResult, config_key


def completed_points(out_dir: str, code: NBCode, cfg: SimConfig) -> set:
    """Eb/N0 points already recorded in results.jsonl for this config
    (checkpoint/resume for interrupted sweeps).

    A point only counts as done if the line's full ``config_key`` (channel,
    CN family and budget knobs, storage and dtype, stop rule; see
    ``sim.mc.config_key``) matches the resuming config's.  Lines without a
    key never match: resume re-runs them rather than risk skipping another
    config's points.
    """
    path = os.path.join(out_dir or "", "results.jsonl")
    done = set()
    if not out_dir or not os.path.exists(path):
        return done
    want = config_key(cfg)
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("code") == code.name and r.get("config_key") == want:
                done.add(round(float(r["ebn0_db"]), 6))
    return done


def run_sweep(
    code: NBCode,
    ebn0_grid: Iterable[float],
    base: SimConfig,
    out_dir: Optional[str] = None,
    verbose: bool = True,
    mesh=None,
    resume: bool = False,
    *,
    device,
) -> list:
    """Run the Monte-Carlo chain at each Eb/N0 point on ``device``, or
    sharded over ``mesh`` (a ``parallel.mesh.Mesh``, whose own device each
    rank runs on); returns SimResults."""
    results = []
    mc = sharded_step = None
    lead = mesh is None or mesh.rank == 0
    verbose = verbose and lead
    done = completed_points(out_dir, code, base) if resume and lead else set()
    if mesh is not None and resume:
        import torch.distributed as dist

        box = [done]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        done = box[0]
    for ebn0 in ebn0_grid:
        if round(float(ebn0), 6) in done:
            if verbose:
                print(f"Eb/N0={ebn0:.2f} dB already recorded; skipping")
            continue
        cfg = dataclasses.replace(base, ebn0_db=float(ebn0))
        if mesh is not None:
            from ..parallel.mesh import run_sharded, sharded_batch_step

            if sharded_step is None:
                sharded_step = sharded_batch_step(code, cfg, mesh)
            r = run_sharded(code, cfg, mesh, verbose=verbose,
                            step=sharded_step)
        else:
            if mc is None:
                mc = MonteCarlo(code, cfg, device=device)
            else:
                mc.cfg = cfg  # Eb/N0 enters the channel only: same loop
            r = mc.run(verbose=verbose)
        results.append(r)
        if verbose:
            lo, hi = r.fer_ci
            print(
                f"Eb/N0={ebn0:.2f} dB  FER={r.fer:.3e} [{lo:.2e},{hi:.2e}] "
                f"({r.frame_errors}/{r.frames})  BER={r.ber:.3e}  "
                f"avg_it={r.avg_iters:.2f}  {r.frames_per_s:.1f} fr/s"
            )
        if out_dir and lead:
            write_results(out_dir, code, r)
    return results


def result_filename(code: NBCode, cfg: SimConfig) -> str:
    """Text result file named like the reference's (NB_LDPC.c:129-136)."""
    d = cfg.decoder
    return (
        f"results_N{code.n}_CR{code.rate:0.2f}_GF{code.q}"
        f"_IT{d.max_iters}_Offset{d.offset:g}_nm{d.nm}_{d.schedule}.txt"
    )


def write_results(out_dir: str, code: NBCode, r: SimResult):
    os.makedirs(out_dir, exist_ok=True)
    txt = os.path.join(out_dir, result_filename(code, r.config))
    stamp = time.strftime("%a %b %d %H:%M:%S %Y")
    with open(txt, "a") as f:
        f.write(
            f" SNR:{r.config.ebn0_db:.2f}: \t FER= {r.frame_errors} / "
            f"{r.frames} = {r.fer:.6f}  \t BER= {r.bit_errors} / x = \t "
            f"{r.ber:.6f}  avr_it= \t {r.avg_iters:.2f} \t time: {stamp}\n"
        )
    jsonl = os.path.join(out_dir, "results.jsonl")
    with open(jsonl, "a") as f:
        f.write(json.dumps(dict(r.to_dict(), time=stamp)) + "\n")
