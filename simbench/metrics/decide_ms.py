"""Device time of the decoder's decisions a batch (the argmin over the
APP, or the flooding totals, and the latch of active frames), ms: from
each decoder step's ``nbldpc_mark_decide`` kernel to its
``nbldpc_mark_syndrome``, summed over the steps of the traced batches.
The decode's reset, which takes the intrinsic's argmin eagerly before the
device loop's graph, carries no marker and is left out."""
from ._marks import span_ms, steps


def read(run):
    return span_ms(run, "decide", "syndrome", steps)
