"""The card's idle share of a batch, %: 1 - (gen + decode + count device
time) / the batch's host wall (the same batch index, run untimed before
the split); mean over the split batches."""
from ._split import mean


def read(run):
    return mean(run, "idle_pct")
