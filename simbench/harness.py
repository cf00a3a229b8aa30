"""One rank's run of a cell: set-up, the measured window, the traced
measurements, and what the correctness check needs.

The window drives the program's own batch step, ``MonteCarlo.step`` (or,
sharded, ``parallel.mesh.sharded_batch_step``): gen -> decode -> count,
batch after batch with fresh batch indices, each batch's counters read to
the host as ``MonteCarlo.run`` reads them.  ``Recorder`` observes the step
from outside, by wrapping ``MonteCarlo.gen`` and ``MonteCarlo.count`` for
the run: it keeps what the check compares for a sample of the batches and,
in the traced run, puts CUDA events and profiler ranges at the span
boundaries gen | decode | count.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import importlib
import os
import tempfile
import time

import numpy as np

WARMUP_BATCHES = 2          # warm-up batches (the first captures)
SPIN_CYCLES = 10 ** 8       # ~50 ms of one spinning thread on an H100
SPLIT_EVERY = 8             # traced run: every 8th batch is split
TRACED_BATCHES = 3          # traced run: batches under the profiler
TRACE_AFTER = 4             # traced run: profiled after this many batches
AGREE_AFTER = 4             # sharded run: batches before the ranks agree
KEEP = 4                    # batches kept for the check, besides the longest
INTR_FRAMES = 1             # frames of a kept batch whose intrinsic is kept


@dataclasses.dataclass
class Kept:
    """What the check reads of one batch."""
    batch: int
    cw: object = None
    intr: object = None          # [INTR_FRAMES, N, q] of frames ``frames``
    decide: object = None
    iters: object = None
    conv: object = None
    local: object = None         # this rank's counters before any exchange
    steps: int = 0


class Recorder:
    """Wraps ``MonteCarlo.gen`` and ``MonteCarlo.count`` (a context
    manager restores them).  Keeps, by reservoir sampling from the seed,
    ``KEEP`` of the window's batches and the batch with the most decoder
    steps; the local counters of every batch; and, when asked, CUDA events
    at the span boundaries."""

    def __init__(self, seed: int, frames: int):
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.frames = np.sort(self.rng.choice(frames, INTR_FRAMES,
                                              replace=False))
        self.on = False              # recording the window's batches
        self.pending = None
        self.kept: dict = {}         # slot -> Kept
        self.longest = None
        self.seen = 0
        self.locals = []             # every batch's local counters (device)
        self.events = None           # list to fill with CUDA events
        self.ranges = False          # open profiler ranges at the spans
        self.span = None             # profiler range of the current span

    @contextlib.contextmanager
    def installed(self, mc_class, device):
        import torch

        gen, count = mc_class.gen, mc_class.count
        rec = self
        frames = torch.as_tensor(self.frames, device=device)

        def gen_hook(mc, batch_idx):
            rec._mark("gen")
            cw, intr = gen(mc, batch_idx)
            rec._mark("decode")
            if rec.on:
                rec.pending = Kept(batch_idx, cw=cw,
                                   intr=intr.index_select(0, frames))
            return cw, intr

        def count_hook(mc, decide, cw, iters, conv):
            rec._mark("count")
            counters, frame_err = count(mc, decide, cw, iters, conv)
            rec._mark(None)
            if rec.on:
                p = rec.pending
                p.decide, p.iters, p.conv, p.local = (decide, iters, conv,
                                                      counters)
                rec.locals.append(counters)
            return counters, frame_err

        mc_class.gen, mc_class.count = gen_hook, count_hook
        try:
            yield self
        finally:
            mc_class.gen, mc_class.count = gen, count

    def _mark(self, span):
        if self.events is not None:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None
        if span is not None and self.ranges:
            import torch

            self.span = torch.profiler.record_function(f"simbench.{span}")
            self.span.__enter__()

    def after_batch(self, steps: int):
        """The batch just read back had ``steps`` decoder steps: keep it if
        the reservoir draws it or it is the longest so far.  Returns its
        record."""
        p, self.pending = self.pending, None
        if p is None:
            return None
        p.steps = steps
        slot = (self.seen if self.seen < KEEP
                else int(self.rng.integers(0, self.seen + 1)))
        self.seen += 1
        longest = self.longest is None or steps > self.longest.steps
        if slot < KEEP or longest:
            # symbols as int16: a kept batch holds ~4 MB of them, not ~16
            import torch

            p.cw, p.decide = p.cw.to(torch.int16), p.decide.to(torch.int16)
        if longest:
            self.longest = p
        if slot < KEEP:
            self.kept[slot] = p
        return p

    def batches(self) -> list:
        """The kept batches, the longest among them, each once."""
        out = {k.batch: k for k in self.kept.values()}
        if self.longest is not None:
            out[self.longest.batch] = self.longest
        return [out[b] for b in sorted(out)]


def imported_program():
    """The program's modules that the harness drives (imported here, not
    at module import)."""
    from ems_nbldpc_torch.decoder import device_loop
    from ems_nbldpc_torch.decoder.api import DecoderConfig
    from ems_nbldpc_torch.models.code import from_parsed
    from ems_nbldpc_torch.models.channels import ChannelSpec
    from ems_nbldpc_torch.models.encoder import gaussian_elimination
    from ems_nbldpc_torch.models.formats import ParsedMatrix
    from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig
    return dict(device_loop=device_loop, DecoderConfig=DecoderConfig,
                from_parsed=from_parsed, ChannelSpec=ChannelSpec,
                gaussian_elimination=gaussian_elimination,
                ParsedMatrix=ParsedMatrix, MonteCarlo=MonteCarlo,
                SimConfig=SimConfig)


def build_kernels(names, device_type: str) -> dict:
    """Build the configuration's kernel libraries side by side (their
    ``build()``; only on a card).  Returns seconds by module."""
    if device_type != "cuda" or not names:
        return {}
    mods = [importlib.import_module(n) for n in names]
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        futs = {m.__name__: pool.submit(m.build) for m in mods}
        return {n: round(f.result()[1], 3) for n, f in futs.items()}


def batch_order(seed: int, pool: int):
    """The window's batch indices: the pool's ``pool`` batches in an order
    drawn from the run's seed, then again in another order, and so on.
    Every seed runs the same batches (the same frames, so the same work)
    in its own order; the window ends on a pass's end (``window``'s
    ``whole``)."""
    rng = np.random.default_rng([seed, 0x0DE7])
    while True:
        yield from (int(b) for b in rng.permutation(pool))


def sim_config(prog, cell: dict, seed: int):
    cfg, traffic = cell["config"], cell["traffic"]
    if traffic["channel"] != "bpsk":
        raise ValueError(f"traffic channel {traffic['channel']!r}: the "
                         "harness draws BPSK / AWGN")
    return prog["SimConfig"](
        ebn0_db=float(traffic["ebn0_db"]),
        frames_per_batch=int(cfg["frames_per_batch"]),
        max_frames=2 ** 62, stop_errors=2 ** 62, seed=seed,
        channel=prog["ChannelSpec"](), encode=cfg["encode"],
        decoder=prog["DecoderConfig"](**cfg["decoder"]))


def make_code(prog, cell: dict, rows, coefs):
    c = cell["config"]["code"]
    parsed = prog["ParsedMatrix"](c["n"], c["m"], c["q"], list(rows),
                                  list(coefs))
    return prog["from_parsed"](parsed, name=cell["config"]["name"])


def stepper(prog, code, cell, seed, device, mesh=None):
    """(step(batch) -> counters [6] on the device, the MonteCarlo class);
    sharded over ``mesh`` when given."""
    cfg = sim_config(prog, cell, seed)
    if mesh is None:
        enc = prog["gaussian_elimination"](code)
        mc = prog["MonteCarlo"](code, cfg, enc, device=device)
        return (lambda b: mc.step(b)[0]), mc
    from ems_nbldpc_torch.parallel.mesh import sharded_batch_step

    return sharded_batch_step(code, cfg, mesh), None


def profiler_warm():
    """An empty tracer session before any CUDA graph is instantiated: a
    graph made before the first session has most of its kernels missing
    from later traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def sync(device_type):
    if device_type == "cuda":
        import torch

        torch.cuda.synchronize()


def window(step, rec: Recorder, seconds: float, order, device_type: str,
           agree=None, trace: bool = False, whole: int = 1) -> dict:
    """The batches of ``order`` (an iterator of batch indices), one after
    another, until ``seconds`` have passed and a whole number of groups of
    ``whole`` batches has run (``batch_order``'s passes over the pool: then
    every seed runs the same batches, each as often).
    ``agree(batches, elapsed)``, where given (a sharded run), is called
    once, after ``AGREE_AFTER`` batches, and returns the window's number of
    batches, the same on every rank (rounded up here to whole groups): no
    rank waits on another's clock after each batch.  Returns the
    batch walls (s), every batch's counters, the window's seconds and,
    traced, the split samples and the profiled stretch."""
    walls, counters = [], []
    splits, prof = [], None
    total = None
    rec.on, rec.ranges = True, trace
    sync(device_type)
    t_start = time.perf_counter()
    for n, b in enumerate(order):
        profiled = trace and TRACE_AFTER <= n < TRACE_AFTER + TRACED_BATCHES
        if profiled and prof is None:
            prof = start_profile()
        t0 = time.perf_counter()
        host = step(b).cpu().numpy()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        counters.append(host)
        kept = rec.after_batch(int(host[5]))
        if profiled:
            prof["iters"].append(kept.iters)
        if prof is not None and n == TRACE_AFTER + TRACED_BATCHES - 1:
            prof = stop_profile(prof)
        if (trace and n % SPLIT_EVERY == SPLIT_EVERY - 1
                and device_type == "cuda"):
            splits.append(split(step, rec, b, t1 - t0))
        elapsed = time.perf_counter() - t_start
        if agree is None:
            if elapsed >= seconds and (n + 1) % whole == 0:
                break
            continue
        if n + 1 == AGREE_AFTER:
            total = -(-agree(n + 1, elapsed) // whole) * whole
        if total is not None and n + 1 >= total:
            break
    rec.on = rec.ranges = False
    if prof is not None and "kernels" not in prof:
        prof = stop_profile(prof)
    return dict(walls=walls, counters=np.array(counters),
                window_s=elapsed, splits=splits, profile=prof)


def split(step, rec: Recorder, b: int, wall: float) -> dict:
    """Batch ``b`` again behind a spin kernel, with CUDA events at its span
    boundaries: its device time by span, and the card's idle share of the
    batch's wall (1 - device time / wall).  ``queued``: the host queued the
    whole batch within the spin, so the spans hold no gap the host made."""
    import torch

    torch.cuda.synchronize()
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    s1.record()
    rec.events, on, ranges = [], rec.on, rec.ranges
    rec.on = rec.ranges = False
    t0 = time.perf_counter()
    counters = step(b)
    host_ms = (time.perf_counter() - t0) * 1e3
    counters.cpu()
    ev, rec.events, rec.on, rec.ranges = rec.events, None, on, ranges
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    gen, decode, count = ms[0], ms[1], ms[2]
    device = gen + decode + count
    return dict(gen_ms=gen, decode_ms=decode, count_ms=count,
                wall_ms=wall * 1e3, device_ms=device,
                idle_pct=100.0 * (1.0 - device / (wall * 1e3)),
                queued=host_ms < s0.elapsed_time(s1))


def start_profile() -> dict:
    from torch.profiler import ProfilerActivity, profile

    p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    p.__enter__()
    return dict(prof=p, t0=time.perf_counter(), iters=[])


def stop_profile(state: dict) -> dict:
    """Closes the session; reads the kernels and the host's ranges from
    its Chrome trace (written under TMPDIR, read, deleted)."""
    import json

    sync("cuda")
    wall = time.perf_counter() - state["t0"]
    state["prof"].__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        state["prof"].export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    kernels = sorted((e["ts"], e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel")
    host = [(e["ts"], e["dur"], e["name"]) for e in events
            if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")
            and "dur" in e]
    return dict(kernels=kernels, host=host, wall_s=wall,
                iters=[it.cpu().numpy() for it in state["iters"]])


def peak_bytes(device_type: str) -> int:
    if device_type != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())
