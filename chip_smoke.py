#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ems_nbldpc_torch``) on one CUDA card.

    python3 chip_smoke.py            # all phases, from the repo root
    python3 chip_smoke.py --profile  # all phases, and trace one batch of
                                     # each full-width chain
                                     # (profile_out/*.json)

Phases; any failure exits non-zero and prints no ``ok`` line.  The code is
random_regular(8100, 4050, 256, dv=2) (N = 8100 symbols = 64800 bits,
R = 1/2, GF(256), dc = 4, 3 super-layers), built once with its encoder.

1. device: requires ``torch.cuda.is_available()``; prints nvidia-smi's card
   name and power limit, and the torch and CUDA versions;
2. build: compiles both CUDA kernels and the device loop's graph helper
   with nvcc (sm_90a), one nvcc per source, started together; prints the
   times and ptxas' register / shared-memory report; then builds the
   full-width code;
3. EMS kernel against plain, bit for bit (``torch.equal``): the bare
   ``ops/cuda_cn.fb_checknode`` against ``minconv.fb_checknode_topk`` on
   truncated rows, and the fused step ``ops/cuda_cn.ems_rows`` against
   ``ems_rows_plain`` (and the torch route around the bare kernel) on
   min-normalised unrotated rows, with the real code's tables, at the
   main paths' shapes (layered [F·1350, 4, 256] with G = 1350 and
   flooding [F·4050, 4, 256] with G = 4050, F = 16 and 128, nm = 32) and
   at odd shapes with padding slots and ``valid`` (q = 16, dc = 12,
   nm = q and truncation off among them), on continuous inputs and on
   "ties" inputs (a few integer levels, so that the lower-GF-id-first
   tie order of the lists matters); at the four main shapes, times the
   fused kernel, the torch route around the bare kernel, the plain
   composition and the bare kernel in turns, beside the bound (bytes
   at 3.35 TB/s against candidates at 67 TFLOP/s);
3b. SPA kernel against plain, both entries.  The bare
   ``ops/cuda_spa.spa_checknode`` against ``fht.spa_checknode_plain`` at
   the main paths' shapes (layered F = 16 and 128 with G = 1350
   coefficient rows, flooding F = 16 with G = 4050) and at odd ones (some
   with padding coefficients), on decoder-like and uniform inputs.  The
   fused super-layer step ``cuda_spa.spa_layer`` against
   ``spa_layer_plain`` (and the pre-fusion torch route around the bare
   kernel) on the real code's three layer plans at F = 16 and 128, and on
   random layer tables with padded slots at odd shapes (q = 16 with
   dc = 12, q = 4 with dc = 2 among them), from a decoder-like state (APP
   one low-cost symbol per column and the rest 2..40, CtoV 0..10, the
   padding column and edge 0) with about a quarter of the frames frozen.
   Tolerance: the kernel's butterflies and the plain version's matrix
   products sum in different orders, and the inverse transform cancels q
   terms of O(1) down to p, which leaves p an f32 error near 1e-7 of the
   best symbol's, i.e. a cost error near 1e-7 * exp(cost): 3e-4 at cost 8,
   2e-2 at cost 12 (measured: 1.3e-2 at q = 16), and no agreement at all
   past cost ~16, where both sides are rounding noise.  So: exp(-cost)
   within atol 1e-5 everywhere, costs within atol 1e-3 where the plain
   cost is <= 8 (the likely symbols, which decide), and padding lanes
   exactly 0; for the fused step the updated CtoV so, APP within 1e-3
   where the plain CtoV is <= 8 (mvc is computed the same way on both
   sides), and frozen frames, the layer's untouched columns and edges and
   the padding column and edge equal bit for bit.  Prints the cost error
   by band; times the fused step, the pre-fusion route, the plain step and
   the bare kernel in turns at F = 16 and 128 beside the fused step's
   bound, and the bare kernel against its plain version;
4. EMS chain at full width: ``MonteCarlo``, F = 128, 256 frames, 2.0 dB,
   layered EMS nm = 32 with ``cn_impl="pallas"`` (one ``ems_rows`` call
   per super-layer), the default ``loop="device"`` (one captured graph
   per decode, ``decoder/device_loop``); checks that one loop (one
   capture) served the timed run, which made no eager launch, that the
   kernel counted on the card the loop's launches per step (3) times the
   decoder steps, that the generated codewords satisfy the syndrome,
   avg_it < 10 and FER <= 0.25;
5. EMS determinism: one batch of 16 frames decoded (host loop) with the
   kernel and with the plain torch CN gives identical decisions and
   iteration counts;
4b. SPA chain at full width (the SPA row of ``bench.py``): layered SPA,
   20 iterations, dense f32, 1.8 dB, F = 128, 256 frames, under the device
   loop and the host loop in turns (device, host, host, device, each loop
   with a MonteCarlo of its own); checks SPA kernel launches = 3 per step
   (counted on the card), all of them ``spa_layer``, the same counts under
   both loops, avg_it < 20, FER <= 0.25;
5b. SPA decode both ways: one batch of 16 frames through the kernel
   (``spa_layer``, 3 launches per step) and through the plain version (no
   launch): identical decisions and convergence, iteration counts within
   1 (differences printed);
4c. list-EMS chain at full width (the EMS row of ``bench.py``): nm = 32,
   nbOper = 64, compressed bf16 CtoV, 10 iterations, 1.8 dB, F = 128, 256
   frames, device loop; checks no kernel launch (the list CN has no kernel
   yet), avg_it < 10, FER <= 0.25;
4d. flooding EMS chain at full width: ``schedule="flooding"``, nm = 32,
   offset 0.3, ``cn_impl="pallas"``, 20 iterations, dense f32, 2.0 dB,
   F = 128, 256 frames, device loop; checks EMS kernel launches = 1 per
   step (one call on all F·M = 518,400 rows), no SPA launch, avg_it < 20,
   FER <= 0.25;
6. the device loop against the host loop at full width, after each chain
   on one batch of its intrinsics (F = 128): layered EMS through K1,
   layered SPA through ``spa_layer``, list-EMS (plain torch), flooding EMS
   through K1 and flooding SPA through the bare K2 (on the flooding
   chain's batch).  A fresh loop decodes (its capture), then decodes
   again after every table cache was emptied and the freed memory
   refilled (the graph reads the tables its loop keeps), then the host
   loop: decisions, iterations and convergence bit-equal; the loop's
   launches per step 3, 3, 0, 1 and 1; the replay makes no eager launch
   and the kernels count per step x steps on the card, as under the host
   loop; prints one decode's wall time under each loop, and the memory
   each loop's decode holds: its live peak and the allocator's reserved
   growth (the graph pool's reserved bytes apart);
5d. flooding EMS decode both ways (host loop): one batch of 16 frames
   through the kernel (launches = 1 per step) and through the plain torch
   CN (no launch): identical decisions, iterations and convergence;
5e. flooding SPA decode both ways: the same 16 frames through the SPA
   kernel's bare entry (launches = 1 per step) and through its plain
   version
   (``plain_spa``): identical decisions and convergence, iteration counts
   within 1 (differences printed);
5f. the plain dense min-conv CN, the compressed dense-CN decoder and
   min-sum through the EMS kernel on the card: random_regular(96, 48, 16),
   64 frames at 1.5 dB, one set of intrinsics, decoded by flooding and
   layered ``cn="minsum"`` (nm = 0, the exact min-sum CN), layered
   ``cn_impl="dense"``, layered ``storage="compressed", cn_impl="topk"``
   (f32), and flooding and layered ``cn="minsum", cn_impl="pallas"``
   (nm = 8), each on the card and on the CPU (plain versions there):
   identical decisions, iterations and convergence; no kernel launch but
   for the two ``pallas`` decodes (1 per flooding step, 1 per super-layer);
6b. odd batches, F = 5, layered SPA and flooding EMS, each against the
   host loop as in 6: uniform random costs (no frame converges: the budget
   ends the loop, 20 steps) and the noiseless all-zero word (every frame
   converges at init: no step runs, no launch);
7. the CLI at full width: the code written as a UBS file with
   ``models/tools.write_ubs``, then ``cli.main`` with the SPA row's
   settings (``--cn spa --iters 20 --batch 128 --max-frames 256 --ebn0
   1.8``, defaults otherwise: device loop, on the card) against
   ``MonteCarlo.run`` of the same config and seed on ``load`` of that
   file: frames, frame errors, bit errors and iteration sum equal.

Each chain runs once to warm up (under the device loop: its capture),
then once timed with the launch counts set to 0 just before and read just
after; both sides of 5d and 5e are counted the same way.  Two counts are
kept: the wrappers' eager launches (``cuda_cn.launches``,
``cuda_spa.launches``) and the launches each kernel counts itself on the
card (``device_launches()``), which a graph's replays move too; a
host-loop run must show the same numbers in both.  After its timed run
each chain times two more batches untraced (``batch_split``): each
batch's host wall time, and its device time from CUDA events around gen,
decode and count with the batch queued behind a spin kernel; the card's
idle share is 1 - device time / wall.  Memory:
the allocator's live peak and its reserved peak (the graph pool, which
holds the replays' temporaries, inside the latter).  The last four lines
are a compact JSON record of each chain's timed runs (and its profile with
``--profile``, which traces a device-loop batch, counts its kernels
against the loop's launches per step times the batch's steps, and fails
the run if the EMS or flooding-EMS trace holds a ``torch.topk`` kernel,
or the SPA trace a kernel other than the fused SPA step's or none),
the card's name and power limit, the kernels' JSON record (for each
kernel the paths it launched in and its launches in each, its per-call
times at the layered and flooding shapes beside its plain version's and
its bound), and ``{"ok": true, "device": {...}}``.  No JAX is imported.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ems_nbldpc_torch import cli
from ems_nbldpc_torch.decoder import device_loop
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.flooding import (_cn_row_tables,
                                               decode_flooding_hostloop,
                                               syndrome_ok)
from ems_nbldpc_torch.decoder.graph import (DeviceGraph, clear_tables,
                                            rotation_table)
from ems_nbldpc_torch.decoder.layered import (_layer_plan,
                                              decode_layered_hostloop)
from ems_nbldpc_torch.gf import get_gf
from ems_nbldpc_torch.models import tools
from ems_nbldpc_torch.models.code import load, random_regular
from ems_nbldpc_torch.models.encoder import gaussian_elimination
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.ops import cuda_cn, cuda_spa
from ems_nbldpc_torch.ops.fht import (position_tables, spa_checknode_plain,
                                      transpose_perm_tables)
from ems_nbldpc_torch.ops.cuda_spa import spa_layer, spa_layer_plain
from ems_nbldpc_torch.ops.minconv import (ems_input_truncate,
                                          ems_output_saturate,
                                          fb_checknode_topk, mask_invalid)
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig
from ems_nbldpc_torch.sim.sweep import result_filename

SLICE_ROWS = 1350          # rows per super-layer of the full-width code
CODE_ROWS = 4050           # rows of the full-width code (one flooding call)
KERNEL_SHAPES = [          # (T, dc, q, nm) of the bare fb_checknode; the
    (16 * SLICE_ROWS, 4, 256, 32),      # first four are the main paths'
    (128 * SLICE_ROWS, 4, 256, 32),     # (layered 5 and 4, then flooding
    (16 * CODE_ROWS, 4, 256, 32),       # 5d and 4d)
    (128 * CODE_ROWS, 4, 256, 32),
    (1000, 3, 16, 5),
    (333, 5, 64, 12),
    (77, 12, 256, 32),
]
ROWS_ODD = [               # (T, G, dc, q, nm, truncate) of ems_rows beside
    (1000, 50, 3, 16, 5, True),         # the main paths' shapes; all with
    (333, 111, 5, 64, 12, True),        # padding slots and valid
    (77, 11, 12, 256, 32, True),
    (90, 9, 12, 16, 16, False),
    (96, 8, 6, 128, 128, True),
    (400, 20, 4, 256, 32, False),
]
KINDS = ("uniform", "ties")
OFFSET = 0.3
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12   # H100 SXM: HBM3, f32 outside
#                                           the tensor cores
SPA_SHAPES = [             # (T, G, dc, q, padding); the first three are the
    (16 * SLICE_ROWS, SLICE_ROWS, 4, 256, False),   # main paths' (layered 5b
    (128 * SLICE_ROWS, SLICE_ROWS, 4, 256, False),  # and 4b, flooding 5e),
    (16 * CODE_ROWS, CODE_ROWS, 4, 256, False),     # all timed
    (1000, 250, 3, 16, False),
    (333, 111, 5, 64, True),
    (77, 11, 12, 256, True),
]
SPA_KINDS = ("decoder", "uniform")
SPA_LAYER_ODD = [          # (F, G, dc, q, padded slots) of spa_layer on
    (8, 250, 3, 16, 5),                 # random layer tables
    (6, 111, 5, 64, 7),
    (4, 11, 12, 256, 4),
    (16, 9, 12, 16, 4),
    (5, 50, 2, 4, 3),
    (3, 40, 6, 128, 6),
    (7, 30, 4, 32, 2),
]
SPA_COST_ATOL, SPA_COST_MAX, SPA_PROB_ATOL = 1e-3, 8.0, 1e-5
LAYERS = 3
SUMMARY = {}               # chain -> its timed run's numbers, printed last


def kernel_input(t, dc, q, nm, kind, seed):
    """Rows as the decoder hands them to the bare CN: seeded, then
    truncated to each message's nm best.  "ties" draws integer levels 0..5,
    so equal values are common inside and at the edge of every nm-best
    list."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 6, (t, dc, q)).astype(np.float32)
    else:
        v = rng.random((t, dc, q), dtype=np.float32) * 9
    return ems_input_truncate(torch.as_tensor(v, device="cuda"), nm).contiguous()


def rows_input(t, dc, q, kind, seed):
    """Unrotated min-normalised rows, as the decoders hand them to
    ``ems_rows``, made on the card from ``seed`` ("ties": levels 0..5)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if kind == "ties":
        v = torch.randint(0, 6, (t, dc, q), generator=gen, device="cuda"
                          ).float()
    else:
        v = 9 * torch.rand((t, dc, q), generator=gen, device="cuda")
    return v - v.min(dim=-1, keepdim=True).values


def odd_tables(g, dc, q, seed):
    """uint8 rotation tables [G, dc, q] and valid [G, dc] for random
    coefficients with a few padding slots (coefficient 0)."""
    rng = np.random.default_rng(seed)
    coefs = rng.integers(1, q, (g, dc))
    coefs[0, -1] = 0
    coefs[rng.integers(0, g, 3), rng.integers(0, dc, 3)] = 0
    gf = get_gf(q)
    tabs = [torch.as_tensor(rotation_table(coefs, gf, d).reshape(g, dc, q)
                            .astype(np.uint8), device="cuda")
            for d in ("in", "out")]
    return tabs[0], tabs[1], torch.as_tensor(coefs != 0, device="cuda")


def old_route(x, rin, rout, valid, nm, offset, truncate):
    """The route before the fused kernel: torch truncation, rotations,
    mask, saturation and normalisation around the bare kernel."""
    t, dc, q = x.shape
    g = rin.shape[0]
    v = x.reshape(t // g, g, dc, q)
    if truncate:
        v = ems_input_truncate(v, nm)
    v = mask_invalid(torch.gather(v, -1, rin.expand_as(v)), valid)
    out = cuda_cn.fb_checknode(v.reshape(t, dc, q), nm).reshape(v.shape)
    out = torch.gather(out, -1, rout.expand_as(out))
    if truncate:
        out = ems_output_saturate(out, nm, offset)
    return (out - out.min(dim=-1, keepdim=True).values).reshape(t, dc, q)


def ems_bound_ms(t, g, dc, q, nm):
    """The least time of one ``ems_rows`` call on an H100: its bytes (rows
    in and out once, the uint8 tables once) at 3.35 TB/s against its
    candidates (one f32 add and one min each, 3 (dc - 2) merges of nm x q
    per row) at 67 TFLOP/s.  Returns (ms, "bytes" or "operations")."""
    nbytes = 2 * 4 * t * dc * q + 2 * g * dc * q
    ops = 2 * t * 3 * (dc - 2) * nm * q
    return bound(nbytes, ops)


def bound(nbytes, ops):
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


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


def check_kernel(graph):
    """3: the EMS kernel against its plain versions; returns the largest
    error (0 when bit-exact) and {(path, T): times} at the main shapes."""
    phase("3 EMS kernel against plain")
    worst = 0.0
    for i, (t, dc, q, nm) in enumerate(KERNEL_SHAPES):
        for kind in KINDS:
            vr = kernel_input(t, dc, q, nm, kind, seed=100 + i)
            got = cuda_cn.fb_checknode(vr, nm)
            want = fb_checknode_topk(vr, nm)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            exact = torch.equal(got, want)
            print(f"fb_checknode T={t} dc={dc} q={q} nm={nm} {kind}: "
                  f"bit-exact={exact} max_abs_err={err}", flush=True)
            check(exact, f"kernel != plain at {(t, dc, q, nm)} {kind}")
            worst = max(worst, err)
            del vr, got, want
    layer = _layer_plan(graph, "cuda")[0]
    rows = _cn_row_tables(graph, "cuda")
    main = {"layered": (layer["rot_in8"], layer["rot_out8"], layer["valid"]),
            "flooding": (rows["rot_in"], rows["rot_out"], rows["valid"])}
    cases = [(path, f * main[path][0].shape[0], *main[path], 32, True)
             for path in ("layered", "flooding") for f in (16, 128)]
    for i, (t, g, dc, q, nm, truncate) in enumerate(ROWS_ODD):
        cases.append(("odd", t, *odd_tables(g, dc, q, seed=i), nm, truncate))
    for i, (path, t, rin, rout, valid, nm, truncate) in enumerate(cases):
        for kind in KINDS:
            _, dc, q = rin.shape
            x = rows_input(t, dc, q, kind, seed=300 + i)
            got = cuda_cn.ems_rows(x, rin, rout, valid, nm, OFFSET, truncate)
            want = cuda_cn.ems_rows_plain(x, rin, rout, valid, nm, OFFSET,
                                          truncate)
            old = old_route(x, rin.long(), rout.long(), valid, nm, OFFSET,
                            truncate)
            torch.cuda.synchronize()
            err = max(float((got - want).abs().max()),
                      float((old - want).abs().max()))
            exact = torch.equal(got, want) and torch.equal(old, want)
            pad = 0 if valid is None else int((~valid).sum())
            print(f"ems_rows {path} T={t} G={rin.shape[0]} dc={dc} q={q} "
                  f"nm={nm} truncate={truncate} padding slots={pad} {kind}: "
                  f"bit-exact={exact} (old route too) max_abs_err={err}",
                  flush=True)
            check(exact, f"ems_rows != plain at {path} T={t} {kind}")
            worst = max(worst, err)
            del x, got, want, old
    times = {}
    for path, t, rin, rout, valid, nm, truncate in cases[:4]:
        x = rows_input(t, 4, 256, "uniform", seed=7)
        rin64, rout64 = rin.long(), rout.long()
        vr = kernel_input(t, 4, 256, nm, "uniform", seed=7)
        fns = {
            "fused": lambda: cuda_cn.ems_rows(x, rin, rout, valid, nm, OFFSET,
                                              truncate),
            "old": lambda: old_route(x, rin64, rout64, valid, nm, OFFSET,
                                     truncate),
            "plain": lambda: cuda_cn.ems_rows_plain(x, rin, rout, valid, nm,
                                                    OFFSET, truncate),
            "bare": lambda: cuda_cn.fb_checknode(vr, nm),
        }
        reps = {"fused": 10, "bare": 10, "old": 3, "plain": 3}
        got = collections.defaultdict(list)
        # in turns, compared within one call only
        for name in ("plain", "old", "fused", "bare", "bare", "fused", "old",
                     "plain"):
            got[name].append(time_ms(fns[name], reps[name]))
        g = rin.shape[0]
        b_ms, b_by = ems_bound_ms(t, g, 4, 256, nm)
        times[(path, t)] = dict(
            {k: sum(v) / 2 for k, v in got.items()}, bound=b_ms, bound_by=b_by)
        print(f"{path} T={t} G={g} dc=4 q=256 nm={nm}: fused "
              + " / ".join(f"{v:.4f}" for v in got["fused"])
              + " ms, old route " + " / ".join(f"{v:.4f}" for v in got["old"])
              + " ms, plain " + " / ".join(f"{v:.4f}" for v in got["plain"])
              + " ms, bare kernel "
              + " / ".join(f"{v:.4f}" for v in got["bare"])
              + f" ms per call; bound {b_ms:.4f} ms ({b_by}), fused at "
              f"{100 * b_ms / times[(path, t)]['fused']:.2f}% of it",
              flush=True)
        del x, vr, rin64, rout64
    return worst, times


def spa_input(t, g, dc, q, kind, padding, seed):
    """(mvc [T, dc, q], coefs [G, dc] int32) on the card, from ``seed``.
    "decoder": each message has one low-cost symbol (0..1) and the rest
    2..40, as a decoder's extrinsics; "uniform": costs 0..9."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (t, dc, q)
    if kind == "decoder":
        mvc = 2 + 38 * torch.rand(shape, generator=gen, device="cuda")
        best = torch.randint(0, q, (t, dc, 1), generator=gen, device="cuda")
        low = torch.rand((t, dc, 1), generator=gen, device="cuda")
        mvc.scatter_(-1, best, low)
    else:
        mvc = 9 * torch.rand(shape, generator=gen, device="cuda")
    lo = 0 if padding else 1
    coefs = torch.randint(lo, q, (g, dc), generator=gen, device="cuda",
                          dtype=torch.int32)
    if padding:
        coefs[0, -1] = 0
    return mvc, coefs


def spa_tables(q):
    return tuple(torch.as_tensor(x, device="cuda")
                 for x in transpose_perm_tables(get_gf(q)))


def spa_state(f, n1, e1, q, cols, edges, seed):
    """A decoder-like layered state on the card, from ``seed``: CtoV
    [F, e1, q] 0..10 and APP [F, n1, q] = X + CtoV on the layer's slots
    (``cols``, ``edges``), X with one low-cost symbol (0..1) per column
    and the rest 2..40, so that APP - CtoV is a decoder's extrinsic (a
    decoder's APP holds the CtoV it subtracts); the padding column and
    edge (the last) 0; active [F] with about a quarter of the frames frozen
    (the first active, the last frozen)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    app = 2 + 38 * torch.rand((f, n1, q), generator=gen, device="cuda")
    best = torch.randint(0, q, (f, n1, 1), generator=gen, device="cuda")
    app.scatter_(-1, best, torch.rand((f, n1, 1), generator=gen,
                                      device="cuda"))
    ctov = 10 * torch.rand((f, e1, q), generator=gen, device="cuda")
    app[:, -1] = 0
    ctov[:, -1] = 0
    cols, edges = cols.long(), edges.long()
    app[:, cols] += ctov[:, edges]
    active = torch.rand(f, generator=gen, device="cuda") >= 0.25
    active[0], active[-1] = True, False
    return app, ctov, active


def odd_layer(g, dc, q, pads, seed):
    """Random layer tables (cols, edges, coefs [G, dc] int32 on the card)
    over N = G dc + 7 columns and E = G dc + 5 edges, ``pads`` slots
    padded (column N, edge E, coefficient 0); returns them with N + 1 and
    E + 1."""
    rng = np.random.default_rng(seed)
    n, e = g * dc + 7, g * dc + 5
    cols = rng.permutation(n)[:g * dc].reshape(g, dc)
    edges = rng.permutation(e)[:g * dc].reshape(g, dc)
    coefs = rng.integers(1, q, (g, dc))
    slots = rng.choice(g * dc, pads, replace=False)
    cols.flat[slots], edges.flat[slots], coefs.flat[slots] = n, e, 0
    up = [torch.as_tensor(x.astype(np.int32), device="cuda")
          for x in (cols, edges, coefs)]
    return (*up, n + 1, e + 1)


def spa_old_route(app, ctov, active, cols, edges, coefs, t_tab, tinv_tab):
    """The layered SPA super-layer before the fused kernel: torch gathers,
    normalisations, freeze and scatters around the bare kernel."""
    act = active[:, None, None, None]
    app_rows = app[:, cols]
    ctov_rows = ctov[:, edges]
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    f, g, dc, q = mvc.shape
    mcv = cuda_spa.spa_checknode(mvc.reshape(f * g, dc, q), coefs, t_tab,
                                 tinv_tab).reshape(mvc.shape)
    mcv = mcv - mcv.min(dim=-1, keepdim=True).values
    mcv = torch.where(act, mcv, ctov_rows)
    new_app = torch.where(act, mvc + mcv, app_rows)
    ctov[:, edges] = mcv
    app[:, cols] = new_app


def spa_layer_bound_ms(f_active, g, dc, q):
    """The least time of one ``spa_layer`` call on an H100: the APP and
    CtoV rows of the active frames read once and written once, the index
    tables and transform tables once, at 3.35 TB/s, against two log2(q)
    stage transforms and ~7 more operations (sub, exp, products, log, add)
    a symbol at 67 TFLOP/s.  Returns (ms, "bytes" or "operations")."""
    sym = f_active * g * dc * q
    nbytes = 4 * 4 * sym + 3 * 4 * g * dc + 2 * q * q
    return bound(nbytes, sym * (2 * int(np.log2(q)) + 7))


def check_layer_case(label, state, tables, old=False):
    """One ``spa_layer`` call against ``spa_layer_plain`` (and, with
    ``old``, the pre-fusion route) on clones of ``state``; checks the
    stated tolerances and bit-equality where nothing may change; returns
    the cost error where the plain cost is <= SPA_COST_MAX."""
    app, ctov, active = state
    cols, edges, coefs, t_tab, tinv_tab = tables
    runs = {"fused": spa_layer, "plain": spa_layer_plain}
    if old:
        runs["old"] = lambda *a: spa_old_route(*a[:3], cols.long(),
                                               edges.long(), *a[5:])
    out = {}
    for name, fn in runs.items():
        a, c = app.clone(), ctov.clone()
        fn(a, c, active, cols, edges, coefs, t_tab, tinv_tab)
        out[name] = (a, c)
    torch.cuda.synchronize()
    real = coefs != 0
    cols_r, edges_r = cols[real].long(), edges[real].long()
    touched_c = torch.zeros(app.shape[1], dtype=torch.bool, device="cuda")
    touched_e = torch.zeros(ctov.shape[1], dtype=torch.bool, device="cuda")
    touched_c[cols_r], touched_e[edges_r] = True, True
    frozen = ~active
    _, c_p = out["plain"]
    want = c_p[active][:, edges_r]
    likely = want <= SPA_COST_MAX
    worst, line, ok = 0.0, [], True
    for name in runs:
        if name == "plain":
            continue
        a, c = out[name]
        same = (torch.equal(a[frozen], app[frozen])
                and torch.equal(c[frozen], ctov[frozen])
                and torch.equal(a[:, ~touched_c], app[:, ~touched_c])
                and torch.equal(c[:, ~touched_e], ctov[:, ~touched_e]))
        got = c[active][:, edges_r]
        diff = (got - want).abs()
        cost_err = float(diff[likely].max()) if bool(likely.any()) else 0.0
        prob_err = float((torch.exp(-got) - torch.exp(-want)).abs().max())
        app_err = float((a[active][:, cols_r] - out["plain"][0][active][
            :, cols_r]).abs()[likely].max()) if bool(likely.any()) else 0.0
        finite = bool(torch.isfinite(a).all() and torch.isfinite(c).all())
        line.append(f"{name}: cost err where plain <= 8 {cost_err:.3e}, "
                    f"exp(-cost) err {prob_err:.3e}, APP err {app_err:.3e}, "
                    f"frozen/untouched/padding bit-equal={same}")
        ok = ok and (finite and same and cost_err <= SPA_COST_ATOL
                     and prob_err <= SPA_PROB_ATOL
                     and app_err <= SPA_COST_ATOL)
        worst = max(worst, cost_err)
    f, g, dc, q = app.shape[0], *cols.shape, app.shape[2]
    pad = int((~real).sum())
    print(f"spa_layer {label} F={f} G={g} dc={dc} q={q} frozen "
          f"{int(frozen.sum())} padding slots={pad}: " + "; ".join(line),
          flush=True)
    check(ok, f"spa_layer != plain at {label}")
    return worst


def check_spa_layer(graph):
    """3b, the fused entry: ``spa_layer`` against ``spa_layer_plain`` on
    the real code's layer plans and on odd random tables; then the timings.
    Returns (largest cost error, {F: times})."""
    worst = 0.0
    code = graph.code
    plans = _layer_plan(graph, "cuda")
    n1, e1 = code.n + 1, graph.n_edges + 1
    for f in (16, 128):
        for k, p in enumerate(plans):
            state = spa_state(f, n1, e1, code.q, p["cols"], p["edge_ids"],
                              seed=400 + f + k)
            worst = max(worst, check_layer_case(
                f"layer {k}", state,
                (p["cols32"], p["edge_ids32"], p["coefs"], p["t_tab"],
                 p["tinv_tab"]), old=True))
            del state
    for i, (f, g, dc, q, pads) in enumerate(SPA_LAYER_ODD):
        cols, edges, coefs, n1o, e1o = odd_layer(g, dc, q, pads, seed=500 + i)
        state = spa_state(f, n1o, e1o, q, cols, edges, seed=600 + i)
        worst = max(worst, check_layer_case(
            "odd", state, (cols, edges, coefs, *spa_tables(q)), old=True))
    times = {}
    p = plans[0]
    tables = (p["cols32"], p["edge_ids32"], p["coefs"], p["t_tab"],
              p["tinv_tab"])
    cols64, edges64 = p["cols"], p["edge_ids"]
    g, dc = p["cols32"].shape
    q = code.q
    for f in (16, 128):
        app, ctov, _ = spa_state(f, n1, e1, q, cols64, edges64, seed=7)
        active = torch.ones(f, dtype=torch.bool, device="cuda")
        copies = {k: (app.clone(), ctov.clone()) for k in ("fused", "old",
                                                          "plain")}
        mvc = app[:, cols64] - ctov[:, edges64]
        mvc = (mvc - mvc.min(dim=-1, keepdim=True).values).reshape(-1, dc, q)
        fns = {
            "fused": lambda: spa_layer(*copies["fused"], active, *tables),
            "old": lambda: spa_old_route(*copies["old"], active, cols64,
                                         edges64, *tables[2:]),
            "plain": lambda: spa_layer_plain(*copies["plain"], active,
                                             *tables),
            "bare": lambda: cuda_spa.spa_checknode(mvc, *tables[2:]),
        }
        reps = {"fused": 10, "bare": 10, "old": 3, "plain": 3}
        got = collections.defaultdict(list)
        # in turns, compared within one call only
        for name in ("plain", "old", "fused", "bare", "bare", "fused", "old",
                     "plain"):
            got[name].append(time_ms(fns[name], reps[name]))
        b_ms, b_by = spa_layer_bound_ms(f, g, dc, q)
        fused = sum(got["fused"]) / 2
        times[f] = dict({k: sum(v) / 2 for k, v in got.items()}, bound=b_ms,
                        bound_by=b_by)
        print(f"spa_layer F={f} G={g} dc={dc} q={q}: fused "
              + " / ".join(f"{v:.4f}" for v in got["fused"])
              + " ms, old route " + " / ".join(f"{v:.4f}" for v in got["old"])
              + " ms, plain " + " / ".join(f"{v:.4f}" for v in got["plain"])
              + " ms, bare kernel "
              + " / ".join(f"{v:.4f}" for v in got["bare"])
              + f" ms per call; bound {b_ms:.4f} ms ({b_by}), fused at "
              f"{100 * b_ms / fused:.2f}% of it", flush=True)
        del app, ctov, copies, mvc, fns
        torch.cuda.empty_cache()
    return worst, times


def check_spa_kernel(graph):
    """3b: the SPA kernel's two entries against their plain versions;
    returns the largest cost error in the stated scope, {T: (bare kernel
    ms, plain ms, bound ms, bound by)} per call at the bare entry's main
    shapes, and the fused entry's {F: times}."""
    phase("3b SPA kernel against plain")
    worst = 0.0
    for i, (t, g, dc, q, padding) in enumerate(SPA_SHAPES):
        t_tab, tinv_tab = spa_tables(q)
        for kind in SPA_KINDS:
            mvc, coefs = spa_input(t, g, dc, q, kind, padding, seed=200 + i)
            got = cuda_spa.spa_checknode(mvc, coefs, t_tab, tinv_tab)
            t_in, t_out = position_tables(coefs, t_tab, tinv_tab)
            want = spa_checknode_plain(mvc.reshape(t // g, g, dc, q), t_in,
                                       t_out).reshape(t, dc, q)
            torch.cuda.synchronize()
            pad = (coefs == 0).repeat(t // g, 1)          # [T, dc]
            real = ~pad
            diff = torch.where(real[..., None], (got - want).abs(), 0.0)
            bands = {c: float(diff.masked_fill(want > c, 0).max())
                     for c in (4.0, SPA_COST_MAX, 12.0, 1e9)}
            cost_err = bands[SPA_COST_MAX]
            prob_err = float((torch.exp(-got) - torch.exp(-want)).abs()
                             [real].max())
            pad_ok = bool((got[pad] == 0).all() and (want[pad] == 0).all())
            finite = bool(torch.isfinite(got).all())
            print(f"spa_checknode T={t} G={g} dc={dc} q={q} {kind}: cost "
                  f"err where plain "
                  f"<= 4 / 8 / 12 / any: " + " / ".join(
                      f"{v:.3e}" for v in bands.values())
                  + f"; exp(-cost) err {prob_err:.3e}; padding lanes "
                  f"{int(pad.sum())} zero={pad_ok}; finite={finite}",
                  flush=True)
            check(finite and pad_ok and cost_err <= SPA_COST_ATOL
                  and prob_err <= SPA_PROB_ATOL,
                  f"SPA kernel != plain at {(t, g, dc, q)} {kind}")
            worst = max(worst, cost_err)
            del mvc, got, want, diff, t_in, t_out
    times = {}
    for t, g, dc, q, padding in SPA_SHAPES[:3]:
        t_tab, tinv_tab = spa_tables(q)
        mvc, coefs = spa_input(t, g, dc, q, "decoder", padding, seed=7)
        t_in, t_out = position_tables(coefs, t_tab, tinv_tab)
        mvc4 = mvc.reshape(t // g, g, dc, q)

        def kern():
            return cuda_spa.spa_checknode(mvc, coefs, t_tab, tinv_tab)

        def plain():
            return spa_checknode_plain(mvc4, t_in, t_out)

        # plain, kernel, kernel, plain: compare within one call only
        p1 = time_ms(plain, 3)
        k1 = time_ms(kern, 10)
        k2 = time_ms(kern, 10)
        p2 = time_ms(plain, 3)
        # bytes: rows in and out, the coefficients and both tables once;
        # operations: two log2(q)-stage transforms per message and ~4 more
        # per element (exp, log, product, normalisation)
        b_ms, b_by = bound(
            8 * mvc.numel() + 4 * coefs.numel() + t_tab.nbytes
            + tinv_tab.nbytes, t * dc * q * (2 * int(np.log2(q)) + 4))
        times[t] = ((k1 + k2) / 2, (p1 + p2) / 2, b_ms, b_by)
        print(f"spa_checknode F={t // g} T={t} G={g} dc={dc} q={q}: kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms per "
              f"call; bound {b_ms:.4f} ms ({b_by})", flush=True)
        del mvc, mvc4, t_in, t_out
    layer_err, layer_times = check_spa_layer(graph)
    return max(worst, layer_err), times, layer_times


def profile_batch(mc, tag, out_dir="profile_out"):
    """Trace one Monte-Carlo batch, after an untraced one (which holds the
    device loop's capture if the loop is new); print the device busy share
    and the device time by kernel (from the exported chrome trace).
    Returns them with the batch's decoder steps and the number of
    ``ems_rows_kernel`` and ``spa_row_kernel`` launches in the trace."""
    from torch.profiler import ProfilerActivity, profile

    phase(f"profile one batch: {tag}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_batch_{tag}.json")
    mc.step(0)[0].cpu()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        counters = mc.step(0)[0].cpu()
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
    topk = sum(1 for e in kernels
               if "gatherTopK" in e["name"] or "bitonicSort" in e["name"])
    print(f"wall {wall_us / 1e3:.3f} ms; {len(kernels)} kernels; device busy "
          f"{busy / 1e3:.3f} ms = {100 * busy / wall_us:.2f}% of wall "
          f"(idle {100 - 100 * busy / wall_us:.2f}%); torch.topk kernels "
          f"(gatherTopK, bitonicSort) {topk}")
    for name, us in by_name.most_common(15):
        print(f"{us / 1e3:10.3f} ms {100 * us / total:6.2f}%  {name}")
    traced = {k: sum(1 for e in kernels if k in e["name"])
              for k in ("ems_rows_kernel", "spa_row_kernel")}
    print(f"decoder steps {int(counters[5])}; kernels in the trace {traced}",
          flush=True)
    return {"wall_ms": round(wall_us / 1e3, 3),
            "busy_pct": round(100 * busy / wall_us, 2), "topk_kernels": topk,
            "steps": int(counters[5]), "traced": traced,
            "spa_kernels": sorted({e["name"] for e in kernels
                                   if "spa_" in e["name"]})}


def check_traced(prof, kernel, per_step, what):
    """The trace holds ``per_step`` launches of ``kernel`` per decoder step
    of its batch (the device loop's replays, seen by the tracer)."""
    check(prof["traced"][kernel] == per_step * prof["steps"] > 0,
          f"{what}: {prof['traced'][kernel]} {kernel} in the trace for "
          f"{prof['steps']} steps, expected {per_step} per step")


SPIN_CYCLES = 10 ** 8      # ~50 ms of one spinning thread on an H100


def batch_split(mc, batches=2):
    """Untraced, for batches 0..``batches``-1: the batch step's host wall
    time (gen, decode, count and the counters' copy to the host, called as
    ``MonteCarlo.step`` calls them), then its device time: the same step
    again behind a spin kernel that keeps the card busy while the host
    queues the batch, with CUDA events around its gen, decode and count,
    so that the spans hold no gap the host made.  That holds when the host
    queued the whole batch within the spin ("queued"), which a step with a
    host read inside (the host loop) cannot.  The card's idle share of a
    batch is then 1 - device time / wall, given per batch (the host's
    clock varies more than the card's).  Returns the means (ms), each
    batch's device time (ms) and idle share (%), and whether every batch
    was queued in time."""
    got = collections.defaultdict(list)
    queued = True
    for b in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mc.step(b)[0].cpu()
        got["wall"].append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        cw, intr = mc.gen(b)
        ev[2].record()
        decide, iters, conv = decode(mc.graph, intr, mc.cfg.decoder)
        ev[3].record()
        counters, _ = mc.count(decide, cw, iters, conv)
        ev[4].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        counters.cpu()
        queued = queued and host_ms < ev[0].elapsed_time(ev[1])
        for i, part in enumerate(("gen", "decode", "count"), start=1):
            got[part].append(ev[i].elapsed_time(ev[i + 1]))
    ms = {k: sum(v) / len(v) for k, v in got.items()}
    device = [sum(got[k][b] for k in ("gen", "decode", "count"))
              for b in range(batches)]
    idle = [100 * (1 - d / w) for d, w in zip(device, got["wall"])]
    print("untraced batch: " + ", ".join(
        f"{k} " + " / ".join(f"{x:.3f}" for x in v) + " ms"
        for k, v in got.items())
        + "; device time " + " / ".join(f"{d:.3f}" for d in device)
        + " ms; idle share " + " / ".join(f"{x:.2f}" for x in idle)
        + f" % (queued within the spin: {queued})", flush=True)
    return dict({k: round(v, 3) for k, v in ms.items()},
                device=[round(d, 3) for d in device],
                idle_pct=[round(x, 2) for x in idle], queued=queued)


def run_chain(name, code, enc, dec, ebn0, mc=None):
    """Warm-up run (skipped when ``mc`` is given: a second timed run), then
    a timed run of 256 frames at F = 128 with every launch count set to 0
    just before it, then ``batch_split``.  Checks that the timed run made
    or replaced no device loop, and its launches: under the device loop
    none eager and, counted by the kernels on the card, the loop's
    launches per step times the decoder steps; under the host loop the
    same numbers eager and on the card.  Memory: the allocator's live and
    reserved peaks during the timed run (the device loop's graph pool is
    reserved memory).  Returns (MonteCarlo, result, {kernel: launches
    counted on the card})."""
    if mc is None:
        cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=128, max_frames=256,
                        stop_errors=10**9, encode="device", decoder=dec)
        t0 = time.perf_counter()
        mc = MonteCarlo(code, cfg, enc, device="cuda")
        print(f"generator upload {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        warm = mc.run()
        print(f"warm-up ({dec.loop} loop; {time.perf_counter() - t0:.2f} s, "
              f"capture included): {warm.frames} frames, FER "
              f"{warm.frame_errors}/{warm.frames}, avg_it "
              f"{warm.avg_iters:.3f}", flush=True)
    torch.cuda.synchronize()
    loop = device_loop.last()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = mc.run()
    launches, eager = read_launches(), read_eager()
    live = torch.cuda.max_memory_allocated()
    held = torch.cuda.max_memory_reserved()
    lp = device_loop.last()
    pool = lp.pool_bytes if lp is not None else 0
    lo, hi = res.fer_ci
    print(f"{name} timed: {res.frames} frames in {res.elapsed_s:.3f} s = "
          f"{res.frames_per_s:.3f} frames/s; avg_it {res.avg_iters:.4f}; "
          f"FER {res.frame_errors}/{res.frames} = {res.fer:.4f} "
          f"[{lo:.4f}, {hi:.4f}]; BER {res.ber:.3e}; decoder steps "
          f"{res.decoder_steps}; launches counted by the kernels {launches}, "
          f"eager {eager}; peak memory live {live / 2**30:.3f} GiB, "
          f"reserved {held / 2**30:.3f} GiB (graph pool "
          f"{pool / 2**30:.3f})", flush=True)
    split = batch_split(mc)
    SUMMARY.setdefault(name, []).append({
        "loop": dec.loop, "fps": round(res.frames_per_s, 3),
        "avg_it": round(res.avg_iters, 4),
        "fer": f"{res.frame_errors}/{res.frames}",
        "steps": res.decoder_steps, "live_gib": round(live / 2**30, 3),
        "reserved_gib": round(held / 2**30, 3),
        "pool_gib": round(pool / 2**30, 3), "untraced": split})
    check(res.frames == 256, f"{name}: {res.frames} frames, expected 256")
    check(res.avg_iters < dec.max_iters,
          f"{name}: avg_it {res.avg_iters} reached the budget")
    check(res.fer <= 0.25, f"{name}: FER {res.fer} > 0.25")
    check(lp is loop, f"{name}: the timed run made a device loop")
    if dec.loop == "device":
        check(sum(eager.values()) == 0,
              f"{name}: eager launches {eager} under the device loop")
        check(launches == {k: v * res.decoder_steps
                           for k, v in lp.per_step.items()},
              f"{name}: launches {launches}, per step {lp.per_step}, "
              f"{res.decoder_steps} steps")
    else:
        check(launches == eager, f"{name}: launches counted by the kernels "
              f"{launches}, eager {eager}")
    return mc, res, launches


def reset_launches():
    """Set both kinds of launch counts to 0 (synchronises the card)."""
    cuda_cn.launches = cuda_spa.launches = cuda_spa.layer_launches = 0
    cuda_cn.reset_device_launches()
    cuda_spa.reset_device_launches()


def read_launches() -> dict:
    """Kernel launches by kernel, counted by the kernels themselves on the
    card (a graph's replays included); "spa_layer" is the part of the SPA
    kernel's launches made by its fused entry."""
    spa, layer = cuda_spa.device_launches()
    return {"fb_checknode": cuda_cn.device_launches(),
            "spa_checknode": spa, "spa_layer": layer}


def read_eager() -> dict:
    """The wrappers' eager launches, by kernel as in ``read_launches``."""
    return {"fb_checknode": cuda_cn.launches,
            "spa_checknode": cuda_spa.launches,
            "spa_layer": cuda_spa.layer_launches}


def read_host_launches(what) -> dict:
    """The launches of host-loop work, where every launch is eager:
    counted by the kernels on the card, and checked equal to the
    wrappers' counts."""
    launches, eager = read_launches(), read_eager()
    check(launches == eager, f"{what}: launches counted by the kernels "
          f"{launches}, eager {eager}")
    return launches


def check_small_card_decodes():
    """5f: the plain dense CN paths and the min-sum route through the EMS
    kernel on the card against the same decodes on the CPU (plain
    versions there), from one set of intrinsics made on the CPU."""
    phase("5f dense min-conv CN, compressed dense-CN decoder and min-sum "
          "through the EMS kernel, card vs CPU")
    code = random_regular(96, 48, 16, seed=0)
    cfg = SimConfig(ebn0_db=1.5, frames_per_batch=64, encode="device")
    _, intr = MonteCarlo(code, cfg, device="cpu").gen(0)
    base = DecoderConfig(max_iters=15, cn="ems", nm=8, offset=0.3,
                         loop="host", storage="dense", dtype="float32")
    for name, dec, per_step in (
            ("flooding minsum", dataclasses.replace(
                base, schedule="flooding", cn="minsum", nm=0), 0),
            ("layered minsum", dataclasses.replace(base, cn="minsum", nm=0,
                                                   cn_impl="auto"), 0),
            ("layered dense", dataclasses.replace(base, cn_impl="dense"), 0),
            ("layered compressed topk", dataclasses.replace(
                base, cn_impl="topk", storage="compressed"), 0),
            ("flooding minsum pallas", dataclasses.replace(
                base, schedule="flooding", cn="minsum", cn_impl="pallas"), 1),
            ("layered minsum pallas", dataclasses.replace(
                base, cn="minsum", cn_impl="pallas"), len(code.layers))):
        reset_launches()
        card = [x.cpu() for x in decode(code, intr.cuda(), dec)]
        launches = read_host_launches(name)
        host = decode(code, intr, dec)
        same = all(torch.equal(a, b) for a, b in zip(card, host))
        steps = int(card[1].max())
        print(f"{name}: identical decisions/iterations/convergence {same}; "
              f"iters max {steps} mean "
              f"{float(card[1].float().mean()):.4f}, converged "
              f"{int(card[2].sum())}/64; launches {launches}", flush=True)
        check(same, f"{name}: card and CPU decodes differ")
        check(steps > 1, f"{name}: uninformative batch")
        check(launches == {"fb_checknode": per_step * steps,
                           "spa_checknode": 0, "spa_layer": 0},
              f"{name}: launched {launches} in {steps} steps")


def free(mc):
    """Drop the device loops (state buffers and graph pools) and a
    MonteCarlo's 4.2 GB generator matrix from the card."""
    device_loop.clear()
    del mc._pmat
    gc.collect()
    torch.cuda.empty_cache()


def memory_mark():
    """(allocated, reserved) bytes now, with the peaks reset to them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def check_loops(path, graph, intr, dec, per_step):
    """6: one batch through a fresh ``loop="device"`` (its capture), again
    through the same loop after every table cache was emptied and the
    freed memory refilled, and through ``loop="host"``: decisions,
    iterations and convergence bit-equal; the loop's launches per step as
    expected; the replay makes no eager launch and its kernels count per
    step x steps on the card, as the host loop's do eagerly and on the
    card.  Prints the wall time of one decode under each loop (the
    replay's and the host loop's), and each loop's memory: the live peak
    and the reserved growth of its first decode (state, the step's
    temporaries, and for the device loop its graph pool, reserved bytes
    apart).  Returns the steps."""
    phase(f"6 device loop vs host loop: {path}")
    device_loop.clear()
    gc.collect()
    torch.cuda.empty_cache()
    mem = {}
    a0, r0 = memory_mark()
    first = [x.cpu() for x in decode(graph, intr, dataclasses.replace(
        dec, loop="device"))]
    lp = device_loop.last()
    mem["device"] = (torch.cuda.max_memory_allocated() - a0,
                     torch.cuda.max_memory_reserved() - r0)
    state = sum(t.nbytes for t in lp.state)
    # the graph reads its tables by address: drop every cached table and
    # hand the freed memory out again before the replay
    clear_tables()
    gc.collect()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << k,), -7, dtype=torch.int64, device="cuda")
            for k in range(8, 27, 2) for _ in range(4)]
    reset_launches()
    t0 = time.perf_counter()
    second = [x.cpu() for x in decode(graph, intr, dataclasses.replace(
        dec, loop="device"))]
    wall_device = time.perf_counter() - t0
    counts = {"device": (read_launches(), read_eager())}
    same_loop = device_loop.last() is lp
    del junk
    gc.collect()
    torch.cuda.empty_cache()
    a0, r0 = memory_mark()
    reset_launches()
    t0 = time.perf_counter()
    host = [x.cpu() for x in decode(graph, intr, dataclasses.replace(
        dec, loop="host"))]
    wall_host = time.perf_counter() - t0
    mem["host"] = (torch.cuda.max_memory_allocated() - a0,
                   torch.cuda.max_memory_reserved() - r0)
    counts["host"] = (read_launches(), read_eager())
    same = all(torch.equal(a, b) for dev in (first, second)
               for a, b in zip(dev, host))
    steps = int(host[1].max())
    want = {k: per_step.get(k, 0) * steps for k in counts["host"][0]}
    none = {k: 0 for k in want}
    gib = 2 ** 30
    print(f"F={intr.shape[0]}: bit-equal decisions/iterations/convergence "
          f"{same}; steps {steps}; converged {int(host[2].sum())}/"
          f"{intr.shape[0]}; launches per step {lp.per_step}; launches "
          f"counted by the kernels / eager: replay {counts['device'][0]} / "
          f"{counts['device'][1]}, host loop {counts['host'][0]} / "
          f"{counts['host'][1]}; one decode: device loop "
          f"{wall_device * 1e3:.3f} ms, host loop {wall_host * 1e3:.3f} ms",
          flush=True)
    print(f"memory of a first decode: device loop live peak "
          f"{mem['device'][0] / gib:.3f} GiB (its state "
          f"{state / gib:.3f}), reserved growth {mem['device'][1] / gib:.3f} "
          f"GiB of which graph pool {lp.pool_bytes / gib:.3f}; host loop "
          f"live peak {mem['host'][0] / gib:.3f} GiB, reserved growth "
          f"{mem['host'][1] / gib:.3f} GiB", flush=True)
    SUMMARY.setdefault("memory", {})[path] = {
        "device_live_gib": round(mem["device"][0] / gib, 3),
        "device_reserved_gib": round(mem["device"][1] / gib, 3),
        "state_gib": round(state / gib, 3),
        "pool_gib": round(lp.pool_bytes / gib, 3),
        "host_live_gib": round(mem["host"][0] / gib, 3),
        "host_reserved_gib": round(mem["host"][1] / gib, 3)}
    check(same, f"{path}: device and host loops differ")
    check(same_loop, f"{path}: the second decode made a new loop")
    check(lp.per_step == {k: per_step.get(k, 0) for k in lp.per_step},
          f"{path}: launches per step {lp.per_step}, expected {per_step}")
    check(counts["device"] == (want, none)
          and counts["host"] == (want, want),
          f"{path}: launches {counts} for {steps} steps")
    return steps


def check_odd_batches(code, decs):
    """6b: a batch in which no frame converges (uniform random costs: the
    budget ends the loop) and one in which every frame converges at init
    (the all-zero word without noise: no step runs), F = 5, through each
    of ``decs`` ({path: (config, launches per step)}) under both loops."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    noise = 10 * torch.rand((5, code.n, code.q), generator=gen,
                            device="cuda")
    noise -= noise.min(dim=-1, keepdim=True).values
    clean = torch.full((5, code.n, code.q), 10.0, device="cuda")
    clean[..., 0] = 0
    graph = DeviceGraph.from_code(code)
    for path, (dec, per_step) in decs.items():
        for label, intr, steps in (("no frame converges", noise,
                                    dec.max_iters),
                                   ("all converge at init", clean, 0)):
            got = check_loops(f"6b {path}, {label}", graph, intr, dec,
                              per_step)
            check(got == steps, f"6b {path} {label}: {got} steps, "
                  f"expected {steps}")
    device_loop.clear()


def check_cli(code):
    """7: the CLI at full width on the code written as a UBS file, with the
    SPA row's settings, against ``MonteCarlo.run`` of the same config and
    seed on ``load`` of that file: frames, frame errors, bit errors and
    iteration sum equal."""
    phase("7 CLI at full width")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "code_N8100_GF256.txt")
        tools.write_ubs(ParsedMatrix(
            code.n, code.m_rows, code.q,
            [code.row_cols[r, :d] for r, d in enumerate(code.row_deg)],
            [code.row_coefs[r, :d] for r, d in enumerate(code.row_deg)]),
            path)
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        rc = cli.main(["--matrix", path, "--cn", "spa", "--iters", "20",
                       "--batch", "128", "--max-frames", "256", "--ebn0",
                       "1.8", "--out", out, "--quiet"])
        seconds = time.perf_counter() - t0
        with open(os.path.join(out, "results.jsonl")) as f:
            (rec,) = [json.loads(line) for line in f]
        device_loop.clear()
        gc.collect()
        torch.cuda.empty_cache()
        cfg = SimConfig(ebn0_db=1.8, frames_per_batch=128, max_frames=256,
                        decoder=DecoderConfig(max_iters=20, cn="spa"))
        loaded = load(path, name=path)
        mc = MonteCarlo(loaded, cfg, device="cuda")
        res = mc.run()
        text = os.path.exists(os.path.join(out, result_filename(loaded,
                                                                cfg)))
        free(mc)
    cli_counts = (rec["frames"], rec["frame_errors"], rec["bit_errors"],
                  round(rec["avg_iters"] * rec["frames"]))
    mc_counts = (res.frames, res.frame_errors, res.bit_errors, res.iter_sum)
    print(f"cli rc {rc} in {seconds:.1f} s (load, encoder, capture and 256 "
          f"frames): frames, frame errors, bit errors, iteration sum "
          f"{cli_counts}; MonteCarlo.run {mc_counts}; text result file "
          f"{text}", flush=True)
    check(rc == 0 and text and cli_counts == mc_counts,
          "the CLI's run differs from MonteCarlo.run")


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

    if "--profile" in argv:
        # start the tracer before any graph is instantiated: a graph made
        # before the first trace had most of its kernels missing from it
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    phase("2 build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = {mod.__name__.rsplit(".", 1)[-1]: pool.submit(mod.build,
                                                               verbose=True)
                  for mod in (cuda_cn, cuda_spa, device_loop)}
        for name, fut in builds.items():
            _, seconds, log = fut.result()
            print(f"nvcc {name} {seconds:.2f} s")
            for line in log.splitlines():
                if "ptxas" in line:
                    print(line.strip())
    print(f"all three built in {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    code = random_regular(8100, 4050, 256, dv=2, seed=0)
    n_layers = len(code.layers)
    print(f"code N={code.n} M={code.m_rows} q={code.q} dc={code.dc_max} "
          f"layers={n_layers} sizes={[len(x) for x in code.layers]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(n_layers == LAYERS, f"{n_layers} super-layers, expected {LAYERS}")
    check(all(len(x) == SLICE_ROWS for x in code.layers)
          and code.m_rows == CODE_ROWS, "unexpected layer sizes")
    graph = DeviceGraph.from_code(code)

    max_err, k_times = check_kernel(graph)
    spa_err, spa_times, layer_times = check_spa_kernel(graph)
    k_main = k_times[("layered", 128 * SLICE_ROWS)]
    k_flood = k_times[("flooding", 128 * CODE_ROWS)]
    spa_main = layer_times[128]                         # layered, F = 128
    spa_flood = spa_times[SPA_SHAPES[2][0]]             # flooding, F = 16

    phase("4 EMS chain")
    paths = {"fb_checknode": {}, "spa_checknode": {}}
    t0 = time.perf_counter()
    enc = gaussian_elimination(code)
    print(f"encoder {time.perf_counter() - t0:.1f} s", flush=True)
    dec = DecoderConfig(max_iters=10, schedule="layered", cn="ems", nm=32,
                        offset=0.3, cn_impl="pallas", storage="dense",
                        dtype="float32")
    mc, res, ems_launches = run_chain("EMS", code, enc, dec, 2.0)
    check(ems_launches["fb_checknode"] == n_layers * res.decoder_steps > 0
          and ems_launches["spa_checknode"] == 0,
          f"launches {ems_launches} for {res.decoder_steps} decoder steps")
    paths["fb_checknode"]["layered EMS"] = ems_launches["fb_checknode"]
    cw, intr = mc.gen(0)
    check(tuple(intr.shape) == (128, code.n, code.q),
          f"intrinsic shape {tuple(intr.shape)}")
    check(bool(torch.isfinite(intr).all()), "non-finite intrinsics")
    check(bool(syndrome_ok(graph, cw).all()), "a codeword fails H")
    print("all 128 codewords of batch 0 satisfy the syndrome", flush=True)
    check_loops("layered EMS", graph, intr, dec, {"fb_checknode": n_layers})

    phase("5 EMS kernel vs plain decode at full width")
    intr16 = intr[:16].contiguous()
    outs = {}
    for impl in ("pallas", "topk"):
        d, it, conv = decode(graph, intr16, dataclasses.replace(
            dec, cn_impl=impl, loop="host"))
        outs[impl] = (d.cpu(), it.cpu(), conv.cpu())
    same = all(torch.equal(a, b) for a, b in zip(outs["pallas"], outs["topk"]))
    print(f"F=16: identical decisions/iterations/convergence: {same}; "
          f"iters {outs['pallas'][1].tolist()}", flush=True)
    check(same, "kernel and plain decodes differ")
    if "--profile" in argv:
        SUMMARY["EMS"][-1]["profile"] = profile_batch(mc, "ems")
        SUMMARY["EMS"][-1]["profile"].pop("spa_kernels")
        check(SUMMARY["EMS"][-1]["profile"]["topk_kernels"] == 0,
              "torch.topk kernels in the EMS chain's profile")
        check_traced(SUMMARY["EMS"][-1]["profile"], "ems_rows_kernel",
                     n_layers, "EMS trace")
    free(mc)
    del mc, cw, intr, intr16

    phase("4b SPA chain, device loop and host loop in turns")
    spa_dec = DecoderConfig(max_iters=20, schedule="layered", cn="spa", nm=0,
                            storage="dense", dtype="float32")
    spa_host = dataclasses.replace(spa_dec, loop="host")
    # device, host, host, device; a fresh MonteCarlo for each loop, so that
    # each peak holds its own loop's memory only
    mc, spa_res, spa_launches = run_chain("SPA", code, enc, spa_dec, 1.8)
    free(mc)
    mc, host_res, host_launches = run_chain("SPA", code, enc, spa_host, 1.8)
    run_chain("SPA", code, enc, spa_host, 1.8, mc=mc)
    free(mc)
    mc, spa_res2, _ = run_chain("SPA", code, enc, spa_dec, 1.8)
    check(spa_launches["spa_checknode"] == spa_launches["spa_layer"]
          == n_layers * spa_res.decoder_steps > 0
          and spa_launches["fb_checknode"] == 0
          and host_launches == spa_launches,
          f"launches {spa_launches} (host loop {host_launches}) for "
          f"{spa_res.decoder_steps} decoder steps")
    check((spa_res.frame_errors, spa_res.iter_sum, spa_res.decoder_steps)
          == (host_res.frame_errors, host_res.iter_sum,
              host_res.decoder_steps),
          "the SPA chain differs between the device and the host loop")
    paths["spa_checknode"]["layered SPA"] = spa_launches["spa_checknode"]
    check_loops("layered SPA", graph, mc.gen(0)[1], spa_dec,
                {"spa_checknode": n_layers, "spa_layer": n_layers})

    phase("5b SPA kernel vs plain decode at full width")
    intr16 = mc.gen(0)[1][:16].contiguous()
    outs = {}
    for plain in (False, True):
        reset_launches()
        d, it, conv = decode_layered_hostloop(graph, intr16, 20, cn="spa",
                                              plain_spa=plain)
        outs[plain] = (d.cpu(), it.cpu(), conv.cpu(),
                       read_host_launches("5b"))
    (d_k, it_k, c_k, l_k), (d_p, it_p, c_p, l_p) = outs[False], outs[True]
    it_diff = (it_k - it_p).abs()
    print(f"F=16: identical decisions {torch.equal(d_k, d_p)}, convergence "
          f"{torch.equal(c_k, c_p)}; iters kernel {it_k.tolist()}, plain "
          f"{it_p.tolist()}; frames whose iteration counts differ: "
          f"{int((it_diff > 0).sum())}; launches kernel {l_k}, plain {l_p}",
          flush=True)
    check(torch.equal(d_k, d_p) and torch.equal(c_k, c_p)
          and int(it_diff.max()) <= 1, "SPA kernel and plain decodes differ")
    check(l_k["spa_layer"] == l_k["spa_checknode"]
          == n_layers * int(it_k.max()) > 0 and l_k["fb_checknode"] == 0
          and sum(l_p.values()) == 0,
          f"layered SPA launches {l_k} (plain {l_p}) for {int(it_k.max())} "
          f"steps")
    if "--profile" in argv:
        prof = profile_batch(mc, "spa")
        names = prof.pop("spa_kernels")
        print(f"SPA kernels in the trace: {names}", flush=True)
        check(names and all("spa_row_kernel<8, true>" in n for n in names),
              f"the SPA trace holds other SPA kernels than the fused step: "
              f"{names}")
        print(f"SPA trace under the device loop: idle "
              f"{100 - prof['busy_pct']:.2f}% of its wall", flush=True)
        check_traced(prof, "spa_row_kernel", n_layers, "SPA trace")
        SUMMARY["SPA"][-1]["profile"] = prof
    free(mc)
    del mc, intr16

    phase("4c list-EMS chain")
    list_dec = DecoderConfig(max_iters=10, schedule="layered", cn="ems",
                             nm=32, offset=0.3, nboper=64,
                             storage="compressed", dtype="bfloat16")
    mc, list_res, list_launches = run_chain("list-EMS", code, enc, list_dec,
                                            1.8)
    check(sum(list_launches.values()) == 0,
          f"launches {list_launches}: the list path has no kernel yet")
    check_loops("layered list-EMS", graph, mc.gen(0)[1], list_dec, {})
    if "--profile" in argv:
        SUMMARY["list-EMS"][-1]["profile"] = profile_batch(mc, "list")
        SUMMARY["list-EMS"][-1]["profile"].pop("spa_kernels")
    free(mc)
    del mc

    phase("4d flooding EMS chain")
    fl_dec = DecoderConfig(max_iters=20, schedule="flooding", cn="ems", nm=32,
                           offset=0.3, cn_impl="pallas", storage="dense",
                           dtype="float32")
    mc, fl_res, fl_launches = run_chain("flooding EMS", code, enc, fl_dec,
                                        2.0)
    check(fl_launches["fb_checknode"] == fl_res.decoder_steps > 0
          and fl_launches["spa_checknode"] == 0,
          f"launches {fl_launches} for {fl_res.decoder_steps} decoder steps")
    paths["fb_checknode"]["flooding EMS"] = fl_launches["fb_checknode"]
    intr = mc.gen(0)[1]
    check_loops("flooding EMS", graph, intr, fl_dec, {"fb_checknode": 1})
    fl_spa = DecoderConfig(max_iters=20, schedule="flooding", cn="spa")
    check_loops("flooding SPA", graph, intr, fl_spa, {"spa_checknode": 1})
    device_loop.clear()
    del intr

    phase("5d flooding EMS kernel vs plain decode at full width")
    intr16 = mc.gen(0)[1][:16].contiguous()
    outs, fl_calls = {}, {}
    for impl in ("pallas", "topk"):
        reset_launches()
        d, it, conv = decode(graph, intr16, dataclasses.replace(
            fl_dec, cn_impl=impl, loop="host"))
        outs[impl] = (d.cpu(), it.cpu(), conv.cpu())
        fl_calls[impl] = read_host_launches("5d")
    same = all(torch.equal(a, b) for a, b in zip(outs["pallas"], outs["topk"]))
    steps16 = int(outs["pallas"][1].max())
    print(f"F=16: identical decisions/iterations/convergence: {same}; "
          f"iters {outs['pallas'][1].tolist()}; launches kernel "
          f"{fl_calls['pallas']}, plain {fl_calls['topk']}", flush=True)
    check(same, "flooding kernel and plain decodes differ")
    check(fl_calls["pallas"]["fb_checknode"] == steps16 > 0
          and fl_calls["pallas"]["spa_checknode"] == 0
          and sum(fl_calls["topk"].values()) == 0,
          f"flooding EMS launches {fl_calls} for {steps16} steps")

    phase("5e flooding SPA kernel vs plain decode at full width")
    outs = {}
    for plain in (False, True):
        reset_launches()
        d, it, conv = decode_flooding_hostloop(graph, intr16, 20, cn="spa",
                                               plain_spa=plain)
        outs[plain] = (d.cpu(), it.cpu(), conv.cpu(),
                       read_host_launches("5e"))
    (d_k, it_k, c_k, l_k), (d_p, it_p, c_p, l_p) = outs[False], outs[True]
    it_diff = (it_k - it_p).abs()
    print(f"F=16: identical decisions {torch.equal(d_k, d_p)}, convergence "
          f"{torch.equal(c_k, c_p)}; iters kernel {it_k.tolist()}, plain "
          f"{it_p.tolist()}; frames whose iteration counts differ: "
          f"{int((it_diff > 0).sum())}; launches kernel {l_k}, plain {l_p}",
          flush=True)
    check(torch.equal(d_k, d_p) and torch.equal(c_k, c_p)
          and int(it_diff.max()) <= 1,
          "flooding SPA kernel and plain decodes differ")
    check(l_k["spa_checknode"] == int(it_k.max()) > 0
          and l_k["spa_layer"] == 0
          and l_k["fb_checknode"] == 0 and sum(l_p.values()) == 0,
          f"flooding SPA launches {l_k} (plain {l_p}) for "
          f"{int(it_k.max())} steps")
    paths["spa_checknode"]["flooding SPA"] = l_k["spa_checknode"]
    if "--profile" in argv:
        SUMMARY["flooding EMS"][-1]["profile"] = profile_batch(mc,
                                                               "flooding")
        SUMMARY["flooding EMS"][-1]["profile"].pop("spa_kernels")
        check(SUMMARY["flooding EMS"][-1]["profile"]["topk_kernels"] == 0,
              "torch.topk kernels in the flooding EMS profile")
        check_traced(SUMMARY["flooding EMS"][-1]["profile"],
                     "ems_rows_kernel", 1, "flooding EMS trace")
    free(mc)
    del mc, intr16

    check_odd_batches(code, {
        "layered SPA": (spa_dec, {"spa_checknode": n_layers,
                                  "spa_layer": n_layers}),
        "flooding EMS": (fl_dec, {"fb_checknode": 1})})
    check_small_card_decodes()
    check_cli(code)

    print(json.dumps({"chains": SUMMARY}, separators=(",", ":")))
    print(card)
    print(json.dumps({"kernels": [{
        "name": "fb_checknode", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/fb_checknode.cu",
        "replaces": "ems_nbldpc_tpu/ops/pallas_cn.py:138",
        "entry_points": ["ems_rows", "fb_checknode"],
        "launches": sum(paths["fb_checknode"].values()),
        "paths": list(paths["fb_checknode"]),
        "launches_by_path": paths["fb_checknode"], "max_abs_err": max_err,
        "rows": 128 * SLICE_ROWS, "ms": k_main["fused"],
        "plain_ms": k_main["plain"], "old_route_ms": k_main["old"],
        "bare_ms": k_main["bare"], "bound_ms": k_main["bound"],
        "bound_by": k_main["bound_by"], "library_ms": None,
        "flooding_rows": 128 * CODE_ROWS, "flooding_ms": k_flood["fused"],
        "flooding_plain_ms": k_flood["plain"],
        "flooding_old_route_ms": k_flood["old"],
        "flooding_bare_ms": k_flood["bare"],
        "flooding_bound_ms": k_flood["bound"],
    }, {
        "name": "spa_checknode", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/spa_checknode.cu",
        "replaces": "ems_nbldpc_tpu/ops/fht.py:249",
        "entry_points": ["spa_layer", "spa_checknode"],
        "launches": sum(paths["spa_checknode"].values()),
        "paths": list(paths["spa_checknode"]),
        "launches_by_path": paths["spa_checknode"], "max_abs_err": spa_err,
        "rows": 128 * SLICE_ROWS, "ms": spa_main["fused"],
        "plain_ms": spa_main["plain"], "old_route_ms": spa_main["old"],
        "bare_ms": spa_main["bare"], "bound_ms": spa_main["bound"],
        "bound_by": spa_main["bound_by"], "library_ms": None,
        "flooding_rows": SPA_SHAPES[2][0], "flooding_ms": spa_flood[0],
        "flooding_plain_ms": spa_flood[1], "flooding_bound_ms": spa_flood[2],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
