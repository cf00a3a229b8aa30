"""Device time of ``decode`` a batch (the device loop's graph: every
decoder step, decisions and syndrome), ms: CUDA events between the end of
gen and the start of count, the batch queued behind a spin kernel; mean
over the split batches."""
from ._split import mean


def read(run):
    return mean(run, "decode_ms")
