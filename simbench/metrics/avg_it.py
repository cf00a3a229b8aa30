"""Decoder iterations a frame over the window: the program's own counters,
iterations summed over frames counted."""


def read(run):
    c = run["counters"]
    return float(c[:, 4].sum() / c[:, 0].sum()) if c[:, 0].sum() else None
