"""Per-layer metrics, one module per metric, found by the metric's name
in ``BENCHMARK.json``: ``read(run) -> float | None``.  ``run`` is the
traced run's record (``simbench.run.traced_record``): ``splits`` (batches
timed by CUDA events behind a spin kernel: gen / decode / count device ms,
wall ms, idle share, whether the host queued the batch in time),
``counters`` (every window batch's counters), ``profile`` (the profiled
stretch: kernels as (start us, duration us, name), host ranges, each
batch's per-frame iteration counts) and ``config`` (the configuration
file).  A reader that finds nothing to read returns None, and the metric
is left out of the result line."""
from __future__ import annotations

import importlib


def reader(name: str):
    return importlib.import_module(f"{__name__}.{name}").read
