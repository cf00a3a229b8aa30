"""Timing + profiling helpers.

Port of ``ems_nbldpc_tpu/utils/timing.py``: wall-clock section timers that
wait for the card, and a thin wrapper over ``torch.profiler`` in place of
the XLA profiler.

``span`` names a stretch of the program's host work ``nbldpc.<name>`` in
a profiler's trace; it records only while a session records.  The batch
step's spans nest as

    nbldpc.step (args: the batch index)
        nbldpc.gen: nbldpc.seed, nbldpc.encode, nbldpc.channel
        nbldpc.decode: nbldpc.capture (first call on the card),
                       nbldpc.reset, nbldpc.launch, nbldpc.readout
        nbldpc.count
    nbldpc.allreduce (a sharded step, after nbldpc.step)

and on the card the device timeline carries marker kernels
(``decoder/device_loop.mark``): ``nbldpc_mark_encode``,
``nbldpc_mark_channel`` and ``nbldpc_mark_end`` in gen, and
``nbldpc_mark_decide`` and ``nbldpc_mark_syndrome`` in every decoder
step.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch._C._autograd import _profiler_enabled

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def timer(label: str, sink: dict | None = None, sync=None):
    """Context timer; ``sync`` is an optional tensor (or list of tensors)
    whose card is synchronised before the clock stops (a CPU tensor needs
    no wait)."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        tensors = sync if isinstance(sync, (list, tuple)) else [sync]
        for t in tensors:
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = sink.get(label, 0.0) + dt
    else:
        print(f"[{label}] {dt*1e3:.2f} ms")


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block with ``torch.profiler`` (the CPU, and the CUDA
    activity whenever a card is present) and write a Chrome trace
    ``trace_<pid>_<ns>.json`` into ``logdir``.  Yields the profiler, whose
    ``key_averages()`` sum the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def recording() -> bool:
    """Whether a profiler session records in this process."""
    return _profiler_enabled()


def span(name: str, args: str | None = None):
    """``torch.profiler.record_function(f"nbldpc.{name}", args)`` while a
    profiler session records, else a context that does nothing."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(f"nbldpc.{name}", args)
