"""Readings that a cell's correctness limits are set from (one card).

    python -m simbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 4

One set-up, then for each seed a window of ``--seconds`` at the cell's own
load, on fresh frames (the seed as the batches' stream seed, in place of
the traffic's pool: it enters the batch draws only), and the check's
numbers as a run gives them (the lower readings).  For each control seed,
the same window, then the same comparison with the control in the
program's place (``check.compare(..., control=True)``: the reference one
precision step below the configuration's; the upper readings).  Both go
through ``check.finish`` and ``check.verdict`` with the configuration's
limits.  Prints one JSON line a seed, with its ``correct``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

from simbench import check, harness, run, spec  # noqa: E402
from simbench.codes import make as make_matrix  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    os.environ.update(run.CACHE_ENV)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("simbench.calibrate needs a CUDA card")
    cfg = cell["config"]
    prog = harness.imported_program()
    rows, coefs = make_matrix(cfg["code"])
    code = harness.make_code(prog, cell, rows, coefs)
    harness.build_kernels(cfg.get("kernels", []), "cuda")
    step, mc = harness.stepper(prog, code, cell, 0, "cuda")
    ref = check.Reference(cfg, rows, coefs)
    ebn0 = float(cell["traffic"]["ebn0_db"])
    print(json.dumps({"cell": cell["name"], "setup_s": time.perf_counter() - T0,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    jobs = [(int(s), False) for s in args.seeds.split(",") if s]
    jobs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in jobs:
        mc.cfg = dataclasses.replace(mc.cfg, seed=seed)
        rec = harness.Recorder(seed, cfg["frames_per_batch"])
        with rec.installed(prog["MonteCarlo"], "cuda"):
            win = harness.window(step, rec, args.seconds,
                                 itertools.count(harness.WARMUP_BATCHES),
                                 "cuda")
        kept = rec.batches()
        t = time.perf_counter()
        raw = check.compare(ref, kept, seed, ebn0, rec.frames,
                            control=control)
        numbers = check.finish(raw, win["counters"], cfg["frames_per_batch"])
        correct, _ = check.verdict(numbers, cfg["check"])
        print(json.dumps({"seed": seed, "control": control,
                          "batches": len(win["walls"]),
                          "kept": [k.batch for k in kept],
                          "steps": [k.steps for k in kept],
                          "check_s": round(time.perf_counter() - t, 3),
                          "correct": correct,
                          **numbers}), flush=True)
        del kept, rec
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
