"""The device loop: one decode as one CUDA graph with on-device early exit.

Port of the JAX package's ``jax.lax.while_loop`` decodes
(``ems_nbldpc_tpu/decoder/layered.py`` ``decode_layered`` and
``decode_layered_list``, ``decoder/flooding.py`` ``decode_flooding``),
whose ``cond`` is ``(it < max_iters) & ~all(conv)``.  On the card a decode
is one launch of a graph ``[set pred] -> [WHILE pred { step }]``
(``csrc/device_loop.cu``): the body is one decoder step, captured once,
whose last op writes the flag ``pred = (it < max_iters) & ~all(conv)``
that the CUDA-graph WHILE node tests.  So the steps run exactly while the
while-loop's ``cond`` holds, with no host read between them, and none runs
after the last frame has converged.

A ``DeviceLoop`` owns static state buffers for one (graph, decoder
configuration, F, dtype, device).  Each decode resets them in place with
the stepper's init (``init_fn(intrinsic, state)``), then launches the one
graph.  Before its first launch it runs one eager warm-up step, where the
first-use host work happens (kernel builds, table uploads, lazy module
loads), empties the allocator's cache as ``torch.cuda.graph`` does, then
captures the step; the reset that follows undoes the warm-up step, so it
shifts no count.  The captured step's temporaries live in a memory pool of
the loop's own, at the addresses of the capture, and the loop keeps every
table the captured step read (``graph.keep_tables``): the graph reads them
by address, and the caches that handed them out may drop them.  On the CPU
the same schedule runs eagerly on the same buffers.  Decisions, iteration
counts and convergence flags come back as clones: the next decode
overwrites the buffers.

Kernel launches: a replay runs the captured kernels without their Python
wrappers, so the wrappers' eager counts (``ops/cuda_cn.launches``,
``ops/cuda_spa.launches``, ``ops/cuda_syndrome.launches``,
``ops/cuda_bubble.launches``, ``ops/cuda_list.launches``,
``ops/cuda_decide.launches``) do not move;
the kernels count their own launches on the card (``device_launches()``
of each wrapper module).  The
capture leaves the eager counts as it found them and records each
kernel's launches per step (``DeviceLoop.per_step``).

Markers: ``mark(name, device)`` launches the empty kernel
``nbldpc_mark_<name>`` (``csrc/device_loop.cu``) that names a span on the
card's timeline: ``decide`` and ``syndrome`` in every decoder step,
``sweep`` at the head of each layered decoder's step (so that the span
from ``sweep`` to ``decide`` is the step's check-node sweep), ``encode``,
``channel`` and ``end`` in ``MonteCarlo.gen``.  Inside the capture a
marker is launched always, so that every replay carries them in every
step; eagerly, on the card only and only while a profiler records
(``utils/timing.recording``); on the CPU never.

Loops are cached in one LRU of ``MAX_CACHED`` entries, since each holds GBs
at full width; ``captures`` counts the graphs captured.  A Monte-Carlo run decodes every batch under one key, so
its loop stays in the cache and one capture serves every batch and every
Eb/N0 point of a sweep.  ``last()`` is the loop of the latest decode;
``clear()`` empties the cache.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import gc
import weakref

import torch

from ..ops import (_build, cuda_bubble, cuda_cn, cuda_decide, cuda_list,
                   cuda_spa, cuda_syndrome)
from ..utils.timing import recording, span
from .graph import keep_tables

MAX_CACHED = 2                   # loops kept by the cache
captures = 0                     # graphs captured since import (set to 0
#                                  to count a run's)
capturing = False                # a step is being captured (``_capture``)
# the marker kernels, in the order of csrc/device_loop.cu's loop_mark
MARKS = ("encode", "channel", "end", "decide", "syndrome", "sweep")

# kernel -> (module, counter) of the wrappers' eager launch counts
_COUNTERS = {"fb_checknode": (cuda_cn, "launches"),
             "spa_checknode": (cuda_spa, "launches"),
             "spa_layer": (cuda_spa, "layer_launches"),
             "syndrome_checknode": (cuda_syndrome, "launches"),
             "syndrome_layer": (cuda_syndrome, "layer_launches"),
             "bubble_checknode": (cuda_bubble, "launches"),
             "bubble_layer": (cuda_bubble, "layer_launches"),
             "list_layer": (cuda_list, "launches"),
             "decide_rows": (cuda_decide, "launches")}

_cache: collections.OrderedDict = collections.OrderedDict()


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the graph helper if it is not built yet (``_build.build``)."""
    return _build.build("device_loop", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    ptr, u64 = ctypes.c_void_p, ctypes.c_ulonglong
    for name, args in (
            ("loop_begin", [ptr, ptr, ctypes.POINTER(ptr),
                            ctypes.POINTER(u64)]),
            ("loop_set", [ptr, u64, ptr]),
            ("loop_end", [ptr, ptr, ctypes.POINTER(ptr)]),
            ("loop_launch", [ptr, ptr]),
            ("loop_mark", [ctypes.c_int, ptr]),
            ("loop_destroy", [ptr, ptr])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"device loop: {what} failed with CUDA error {err}")


def _launch_mark(which: int, device: torch.device) -> None:
    _check(_lib().loop_mark(
        which, torch.cuda.current_stream(device).cuda_stream), "marker")


def mark(name: str, device: torch.device) -> None:
    """Launch the marker kernel ``nbldpc_mark_<name>`` (``MARKS``) on
    ``device``'s current stream: while a step is captured, or on the card
    while a profiler records; else nothing."""
    if capturing or (device.type == "cuda" and recording()):
        _launch_mark(MARKS.index(name), device)


def launch_counts() -> dict:
    """The wrappers' eager launch counts, by kernel."""
    return {k: getattr(m, a) for k, (m, a) in _COUNTERS.items()}


class DeviceLoop:
    """One decoder's schedule of at most ``max_iters`` steps on static
    state buffers.

    ``init_fn(intrinsic)`` returns a fresh state (..., decide, conv, iters)
    and ``init_fn(intrinsic, state)`` resets ``state`` in place;
    ``step_fn(state)`` runs one step, in place on the big tensors, and
    returns the new state, whose fresh tensors are copied into the buffers.
    """

    def __init__(self, init_fn, step_fn, max_iters: int):
        self.init_fn, self.step_fn, self.max_iters = init_fn, step_fn, max_iters
        self.state = None        # the static buffers
        self.it = None           # [] int32: steps run
        self.pred = None         # [] bool: (it < max_iters) & ~all(conv)
        self.tables = {}         # the tables the latest step read
        self.exec = None         # the instantiated graph (card only)
        self.pool = None         # the captured step's memory pool
        self.pool_bytes = 0      # device memory the capture reserved
        self.per_step = {}       # kernel -> launches per step (capture)

    def __call__(self, intrinsic: torch.Tensor):
        """Returns (decide [F, N] int64, iters [F] int32, converged [F] bool)."""
        cuda = intrinsic.device.type == "cuda"
        if cuda and self.exec is None:
            with span("capture"):
                self._reset(intrinsic)
                self._capture()
        with span("reset"):
            self._reset(intrinsic)
        with span("launch"):
            if cuda:
                _check(_lib().loop_launch(
                    self.exec, torch.cuda.current_stream().cuda_stream),
                    "launch")
            else:
                while bool(self.pred):
                    self._step()
        with span("readout"):
            decide, conv, iters = self.state[-3:]
            return decide.clone(), iters.clone(), conv.clone()

    def _reset(self, intrinsic):
        if self.state is None:
            # a copy, so that no buffer aliases the caller's intrinsic
            self.state = self.init_fn(intrinsic.clone())
            self.it = torch.zeros((), dtype=torch.int32,
                                  device=intrinsic.device)
            self.pred = torch.empty((), dtype=torch.bool,
                                    device=intrinsic.device)
        self.init_fn(intrinsic, self.state)
        self.it.zero_()
        self._update_pred()

    def _update_pred(self):
        torch.logical_and(self.it < self.max_iters, ~self.state[-2].all(),
                          out=self.pred)

    def _step(self):
        self.tables = {}
        with keep_tables(self.tables):
            new_state = self.step_fn(self.state)
        for buf, new in zip(self.state, new_state):
            if new is not buf:
                buf.copy_(new)
        self.it += 1
        self._update_pred()

    def _capture(self):
        lib = _lib()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._step()                                  # warm-up
        stream.synchronize()
        # the warm-up's temporaries leave the cache, as torch.cuda.graph
        # empties it before a capture: the pool below holds their copies
        gc.collect()
        torch.cuda.empty_cache()
        self.pool = torch.cuda.MemPool()
        graph, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
        s, pred = stream.cuda_stream, self.pred.data_ptr()
        _check(lib.loop_begin(s, pred, ctypes.byref(graph),
                              ctypes.byref(handle)), "graph build")
        before = launch_counts()
        reserved = torch.cuda.memory_reserved()
        exec_, captured = ctypes.c_void_p(), False
        global capturing
        try:
            with torch.cuda.stream(stream), torch.cuda.use_mem_pool(self.pool):
                capturing = True
                self._step()
                _check(lib.loop_set(s, handle, pred), "condition launch")
            captured = True
        finally:
            capturing = False
            after = launch_counts()
            for k, (m, a) in _COUNTERS.items():
                setattr(m, a, before[k])
            err = lib.loop_end(s, graph, ctypes.byref(exec_))
            if err or not captured:
                lib.loop_destroy(exec_, graph)
        _check(err, "capture")
        weakref.finalize(self, lib.loop_destroy, exec_, graph)
        self.per_step = {k: after[k] - before[k] for k in before}
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.exec = exec_
        global captures
        captures += 1


def run(key, make_stepper, intrinsic: torch.Tensor, max_iters: int):
    """Decode ``intrinsic`` with the cached loop of ``key`` (a decoder and
    its configuration; the shape, dtype and device are added here) over
    ``make_stepper()``'s (init_fn, step_fn), made if no cached loop has
    it."""
    key = key + (max_iters, tuple(intrinsic.shape), intrinsic.dtype,
                 str(intrinsic.device))
    loop = _cache.pop(key, None)
    if loop is None:
        loop = DeviceLoop(*make_stepper(), max_iters)
    _cache[key] = loop                                 # the newest entry
    while len(_cache) > MAX_CACHED:
        _cache.popitem(last=False)
    return loop(intrinsic)


def last():
    """The loop of the latest decode (None when the cache is empty)."""
    return next(reversed(_cache.values()), None)


def clear() -> None:
    """Empty the cache (a loop's buffers, graph and pool go with the last
    reference to it)."""
    _cache.clear()
