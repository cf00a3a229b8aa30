#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ems_nbldpc_torch``) on one CUDA card.

    python3 chip_smoke.py            # all phases, from the repo root
    python3 chip_smoke.py --profile  # all phases, then trace one batch
                                     # (writes profile_out/profile_batch.json)

Phases; any failure exits non-zero and prints no ``ok`` line:

1. device: requires ``torch.cuda.is_available()``; prints nvidia-smi's card
   name and power limit, and the torch and CUDA versions;
2. build: compiles the CUDA check node with nvcc (sm_90a), prints the time
   and ptxas' register / shared-memory report;
3. kernel against plain: ``ops/cuda_cn.fb_checknode`` must equal its plain
   torch version (``minconv.fb_checknode_topk``) bit for bit
   (``torch.equal``) at the main path's shape and at ragged / odd shapes,
   on continuous inputs and on "ties" inputs (a few integer levels, so
   that the lower-GF-id-first tie order of the lists matters); prints
   both per-call times;
4. full chain at full width: ``MonteCarlo`` on random_regular(8100, 4050,
   256, dv=2) (N = 8100 symbols = 64800 bits, R = 1/2, GF(256), dc = 4,
   3 super-layers), F = 128, 256 frames, 2.0 dB, layered EMS nm = 32 with
   ``cn_impl="pallas"``; checks that every kernel launch of the timed run
   came from the decoder (3 per host-loop step), that the generated
   codewords satisfy the syndrome, avg_it < 10 and FER <= 0.25;
5. determinism at full width: one batch of 16 frames decoded with the
   kernel and with the plain torch CN gives identical decisions and
   iteration counts.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the kernels' JSON record.  No JAX is imported.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.flooding import syndrome_ok
from ems_nbldpc_torch.models.code import random_regular
from ems_nbldpc_torch.ops import cuda_cn
from ems_nbldpc_torch.ops.minconv import ems_input_truncate, fb_checknode_topk
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig

SLICE_ROWS = 1350          # rows per super-layer of the full-width code
KERNEL_SHAPES = [          # (T, dc, q, nm); the first rows are the main path's
    (16 * SLICE_ROWS, 4, 256, 32),
    (128 * SLICE_ROWS, 4, 256, 32),
    (1000, 3, 16, 5),
    (333, 5, 64, 12),
    (77, 12, 256, 32),
]
KINDS = ("uniform", "ties")


def kernel_input(t, dc, q, nm, kind, seed):
    """Rows as the decoder hands them to the CN: seeded, then truncated to
    each message's nm best.  "ties" draws integer levels 0..5, so equal
    values are common inside and at the edge of every nm-best list."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 6, (t, dc, q)).astype(np.float32)
    else:
        v = rng.random((t, dc, q), dtype=np.float32) * 9
    return ems_input_truncate(torch.as_tensor(v, device="cuda"), nm).contiguous()


def phase(name):
    print(f"== {name}", flush=True)


def check(ok, what):
    """Fail the run (non-zero exit, no ok line) unless ``ok``."""
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        "nvidia-smi failed")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel():
    phase("3 kernel against plain")
    worst = 0.0
    for i, (t, dc, q, nm) in enumerate(KERNEL_SHAPES):
        for kind in KINDS:
            vr = kernel_input(t, dc, q, nm, kind, seed=100 + i)
            got = cuda_cn.fb_checknode(vr, nm)
            want = fb_checknode_topk(vr, nm)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            exact = torch.equal(got, want)
            print(f"T={t} dc={dc} q={q} nm={nm} {kind}: bit-exact={exact} "
                  f"max_abs_err={err}", flush=True)
            check(exact, f"kernel != plain at {(t, dc, q, nm)} {kind}")
            worst = max(worst, err)
            del vr, got, want
    times = {}
    for t, dc, q, nm in KERNEL_SHAPES[:2]:
        vr = kernel_input(t, dc, q, nm, "uniform", seed=7)

        def kern():
            return cuda_cn.fb_checknode(vr, nm)

        def plain():
            return fb_checknode_topk(vr, nm)

        # plain, kernel, kernel, plain: compare within one call only
        p1 = time_ms(plain, 3)
        k1 = time_ms(kern, 10)
        k2 = time_ms(kern, 10)
        p2 = time_ms(plain, 3)
        times[t] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"T={t} dc={dc} q={q} nm={nm}: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms per call", flush=True)
    return worst, times[KERNEL_SHAPES[1][0]]


def profile_batch(mc, out_dir="profile_out"):
    """Trace one Monte-Carlo batch; print the device busy share and the
    device time by kernel (from the exported chrome trace)."""
    from torch.profiler import ProfilerActivity, profile

    phase("profile one batch")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "profile_batch.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mc.step(0)[0].cpu()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = collections.Counter()
    spans = []
    for e in kernels:
        by_name[e["name"][:90]] += e["dur"]
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    total = sum(by_name.values())
    print(f"wall {wall_us / 1e3:.3f} ms; {len(kernels)} kernels; device busy "
          f"{busy / 1e3:.3f} ms = {100 * busy / wall_us:.2f}% of wall "
          f"(idle {100 - 100 * busy / wall_us:.2f}%)")
    for name, us in by_name.most_common(15):
        print(f"{us / 1e3:10.3f} ms {100 * us / total:6.2f}%  {name}")


def main(argv) -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2 build")
    _, seconds, log = cuda_cn.build(verbose=True)
    print(f"nvcc build {seconds:.2f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            print(line.strip())

    max_err, (k_ms, p_ms) = check_kernel()

    phase("4 full chain")
    t0 = time.perf_counter()
    code = random_regular(8100, 4050, 256, dv=2, seed=0)
    n_layers = len(code.layers)
    print(f"code N={code.n} M={code.m_rows} q={code.q} dc={code.dc_max} "
          f"layers={n_layers} sizes={[len(x) for x in code.layers]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(n_layers == 3, f"{n_layers} super-layers, expected 3")
    dec = DecoderConfig(max_iters=10, schedule="layered", cn="ems", nm=32,
                        offset=0.3, cn_impl="pallas", loop="host",
                        storage="dense", dtype="float32")
    cfg = SimConfig(ebn0_db=2.0, frames_per_batch=128, max_frames=256,
                    stop_errors=10**9, encode="device", decoder=dec)
    t0 = time.perf_counter()
    mc = MonteCarlo(code, cfg, device="cuda")
    print(f"encoder + generator upload {time.perf_counter() - t0:.1f} s",
          flush=True)
    warm = mc.run()
    print(f"warm-up: {warm.frames} frames, FER {warm.frame_errors}/"
          f"{warm.frames}, avg_it {warm.avg_iters:.3f}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_cn.launches = 0
    res = mc.run()
    launches = cuda_cn.launches
    peak = torch.cuda.max_memory_allocated()
    lo, hi = res.fer_ci
    print(f"timed: {res.frames} frames in {res.elapsed_s:.3f} s = "
          f"{res.frames_per_s:.3f} frames/s; avg_it {res.avg_iters:.4f}; "
          f"FER {res.frame_errors}/{res.frames} = {res.fer:.4f} "
          f"[{lo:.4f}, {hi:.4f}]; BER {res.ber:.3e}; decoder steps "
          f"{res.decoder_steps}; kernel launches {launches}; peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    check(res.frames == 256, f"{res.frames} frames, expected 256")
    check(launches == n_layers * res.decoder_steps > 0,
          f"{launches} kernel launches for {res.decoder_steps} decoder steps")
    check(res.avg_iters < 10, f"avg_it {res.avg_iters} reached the budget")
    check(res.fer <= 0.25, f"FER {res.fer} > 0.25")
    cw, intr = mc.gen(0)
    check(tuple(intr.shape) == (128, code.n, code.q),
          f"intrinsic shape {tuple(intr.shape)}")
    check(bool(torch.isfinite(intr).all()), "non-finite intrinsics")
    check(bool(syndrome_ok(mc.graph, cw).all()), "a codeword fails H")
    print("all 128 codewords of batch 0 satisfy the syndrome", flush=True)

    phase("5 kernel vs plain decode at full width")
    intr16 = intr[:16].contiguous()
    outs = {}
    for impl in ("pallas", "topk"):
        d, it, conv = decode(mc.graph, intr16,
                             dataclasses.replace(dec, cn_impl=impl))
        outs[impl] = (d.cpu(), it.cpu(), conv.cpu())
    same = all(torch.equal(a, b) for a, b in zip(outs["pallas"], outs["topk"]))
    print(f"F=16: identical decisions/iterations/convergence: {same}; "
          f"iters {outs['pallas'][1].tolist()}", flush=True)
    check(same, "kernel and plain decodes differ")
    if "--profile" in argv:
        profile_batch(mc)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "fb_checknode", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/fb_checknode.cu",
        "replaces": "ems_nbldpc_tpu/ops/pallas_cn.py:138",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
