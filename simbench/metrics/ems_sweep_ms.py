"""Device time of the torch passes around K1 in the layered sweep a batch
(the gathers, normalisation, freeze and scatters of ``layered``'s dense
iteration), ms: from each decoder step's ``nbldpc_mark_sweep`` kernel to
its ``nbldpc_mark_decide``, less the traced time of the K1 launches
(``ems_rows_kernel``) that start inside it, summed over the steps of the
traced batches.  The markers must match the batches' steps as
``_marks.span_ms`` checks them, and a span the tracer lost is stood in
for by the mean of the others, by the same rule; None where the trace has
no ``sweep`` marker (a program without it)."""
from bisect import bisect_left

from ._marks import _BOUNDARY, span_ms, steps

K1 = "ems_rows_kernel"


def read(run):
    if span_ms(run, "sweep", "decide", steps) is None:
        return None
    prof = run["profile"]
    marks = [(ts, m.group(1) or m.group(2)) for ts, _, name in prof["kernels"]
             if (m := _BOUNDARY.search(name))]
    k1 = [(ts, dur) for ts, dur, name in prof["kernels"] if K1 in name]
    k1_ts = [ts for ts, _ in k1]
    spans = []
    for (start, name), (stop, after) in zip(marks, marks[1:]):
        if name == "sweep" and after == "decide":
            lo, hi = bisect_left(k1_ts, start), bisect_left(k1_ts, stop)
            spans.append(stop - start - sum(d for _, d in k1[lo:hi]))
    want = sum(steps(iters) for iters in prof["iters"])
    return sum(spans) / len(spans) * want / 1e3 / len(prof["iters"])
