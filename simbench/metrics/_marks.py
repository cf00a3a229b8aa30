"""Device spans between the program's marker kernels.

The program launches an empty kernel ``nbldpc_mark_<name>`` at each
boundary of its spans (``ems_nbldpc_torch/decoder/device_loop.mark``):
``encode``, ``channel`` and ``end`` once in each batch's gen; ``decide``
and ``syndrome`` in every decoder step, inside the device loop's graph,
whose step ends with its ``set_condition`` kernel.  A span runs from its
marker's start to the start of the next boundary kernel (a marker or
``set_condition``), which must be the one that closes it.

The tracer loses kernels.  On the H100 it lost the closing
``set_condition`` (and a few kernels before it) of the first step of a
profiled stretch's first graph replay in most stretches, and once, in a
session started just before a batch, the batch's first kernels.  A span
whose closing kernel is missing, or the stretch's first span where the
trace begins with its closing marker (the tracer began after its start),
is left out, and the mean of the others stands in for it, for at most
one span a traced batch: the spans of one reader are the same work (gen's
for every batch, the decisions and the syndrome over all F frames at
every step).  Any other missing marker, and any extra one, is a
mismatch.
"""
from __future__ import annotations

import re
import sys

_BOUNDARY = re.compile(r"nbldpc_mark_([a-z]+)|(set_condition)")


def span_ms(run: dict, start: str, stop: str, per_batch):
    """ms a traced batch of the spans from each ``nbldpc_mark_<start>`` to
    the boundary ``stop`` that follows it (a marker's name, or
    ``set_condition``).  ``per_batch(iters)``: the spans a batch with
    per-frame iteration counts ``iters`` holds.  None where the trace has
    no such marker (a program without them); None, with one line on
    standard error, where the markers do not match the traced batches."""
    prof = run.get("profile")
    if not prof or not prof["iters"]:
        return None
    bounds = []
    for ts, _, name in prof["kernels"]:
        m = _BOUNDARY.search(name)
        if m:
            bounds.append((ts, m.group(1) or m.group(2)))
    starts = [i for i, (_, b) in enumerate(bounds) if b == start]
    if not starts:
        return None
    batches = len(prof["iters"])
    want = sum(per_batch(iters) for iters in prof["iters"])
    stops = (len(starts) if stop == "set_condition"
             else sum(b == stop for _, b in bounds))
    spans = [bounds[i + 1][0] - bounds[i][0] for i in starts
             if i + 1 < len(bounds) and bounds[i + 1][1] == stop]
    late = bounds[0][1] == stop              # the first start not traced
    lost = want - len(spans)
    if (len(starts) != want - late or stops != want or lost > batches
            or not spans):
        print(f"marks {start}: {len(starts)} traced, {stops} {stop}, "
              f"{want} expected from the batches' steps, {lost} not closed "
              f"by {stop}; not read", file=sys.stderr)
        return None
    if lost:
        print(f"marks {start}: {lost} of {want} spans lost a boundary to "
              "the tracer; the mean of the others stands in",
              file=sys.stderr)
    return sum(spans) / len(spans) * want / 1e3 / batches


def once(iters) -> int:
    """One span a batch (gen's)."""
    return 1


def steps(iters) -> int:
    """One span a decoder step: the batch's steps are its largest
    per-frame iteration count."""
    return int(iters.max()) if len(iters) else 0
