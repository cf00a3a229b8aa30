"""Device time of ``MonteCarlo.gen`` a batch (source, encoder GEMM,
channel and demapper), ms: CUDA events at the gen span's ends, the batch
queued behind a spin kernel; mean over the split batches."""
from ._split import mean


def read(run):
    return mean(run, "gen_ms")
