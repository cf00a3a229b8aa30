"""One rank's whole run: set-up, warm-up, the window, then the check.

``run_rank`` returns a plain record (numbers and NumPy arrays only); the
entry point (``simbench.run``) turns the records of a cell's ranks into the
result line.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np

from . import check, harness
from .codes import make as make_matrix

FORBIDDEN = ("jax", "jaxlib", "flax", "ems_nbldpc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, Flax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_rank(cell: dict, seed: int, seconds: float, trace: bool, device: str,
             t0: float, mesh=None, agree=None, clock=time.perf_counter,
             barrier=None, control=False) -> dict:
    """``t0``: the process's start on ``clock``; set-up is counted from it
    to the window's first batch.  ``mesh``: this rank's frame-sharding mesh
    (None: one card, ``MonteCarlo.step``).  ``agree``: how a sharded
    run's ranks agree on the window's length (``harness.window``);
    ``barrier()``: a sharded run's ranks wait
    for each other once set-up is done, and once before the others make
    their batch step and after rank 0 has made its own, so that rank 0
    alone writes the program's encoder cache in a checkout's first run
    (the ranks would write one temporary file at once).  ``control``: the
    check compares the control in the program's place
    (``check.compare``)."""
    import torch

    cfg = cell["config"]
    device_type = torch.device(device).type
    parts = {}

    def mark(name, since):
        now = clock()
        parts[name] = round(now - since, 3)
        return now

    t = clock()
    if trace and device_type == "cuda":
        harness.profiler_warm()
    prog = harness.imported_program()
    t = mark("import_s", t)
    rows, coefs = make_matrix(cfg["code"])
    code = harness.make_code(prog, cell, rows, coefs)
    t = mark("code_s", t)
    builds = harness.build_kernels(cfg.get("kernels", []), device_type)
    t = mark("build_s", t)
    if barrier is not None and mesh.rank != 0:
        barrier()
    traffic = cell["traffic"]
    pool_seed, pool = int(traffic["pool_seed"]), int(traffic["pool_batches"])
    step, mc = harness.stepper(prog, code, cell, pool_seed, device, mesh)
    if barrier is not None and mesh.rank == 0:
        barrier()
    t = mark("encoder_upload_s", t)
    rec = harness.Recorder(seed, cfg["frames_per_batch"])
    with rec.installed(prog["MonteCarlo"], device):
        for b in range(pool, pool + harness.WARMUP_BATCHES):
            step(b).cpu()
        harness.sync(device_type)
        t = mark("warmup_s", t)
        if barrier is not None:
            barrier()
        if device_type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = clock() - t0
        win = harness.window(step, rec, seconds,
                             harness.batch_order(seed, pool), device_type,
                             agree, trace and device_type == "cuda",
                             whole=pool)
    peak = harness.peak_bytes(device_type)
    shape = dict(layers=[len(r) for r in code.layers], dc=code.dc_max,
                 q=code.q)
    loop = prog["device_loop"].last()
    pool = int(loop.pool_bytes) if loop is not None else 0
    locals_ = np.array([c.cpu().numpy() for c in rec.locals])
    kept = rec.batches()
    frames_idx = rec.frames
    # the program's state goes before the reference runs
    del step, mc, loop, code
    prog["device_loop"].clear()
    rec.locals = rec.kept = rec.longest = None
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()
    t = clock()
    ref = check.Reference(cfg, rows, coefs)
    shard = None if mesh is None else mesh.rank
    raw = check.compare(ref, kept, pool_seed, float(traffic["ebn0_db"]),
                        frames_idx, shard, sample_seed=seed,
                        control=control)
    raw["reference_s"] = round(clock() - t, 3)
    raw["kept_batches"] = [k.batch for k in kept]
    return dict(setup_s=setup_s, parts=parts, builds=builds, peak=peak,
                pool_bytes=pool, window=win, locals=locals_, raw=raw,
                shape=shape, forbidden=forbidden_modules())
