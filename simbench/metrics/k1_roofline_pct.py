"""K1 (``ems_rows_kernel`` in its dense mode, the min-sum check node)
against its roofline bound, %: the bounds of the traced launches, each at
the frames still active at its step, over their traced time.  The kernel
works on every frame of the batch, so the share reads low by the share of
frozen frames."""
from simbench import roofline
from simbench.bounds import ems_dense


def read(run):
    return roofline.share(run, ("ems_rows_kernel",), ems_dense.bound_ms)
