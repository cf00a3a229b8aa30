"""K3 (``list_kernel`` / ``list_general_kernel``, the list-EMS super-layer
step) against its roofline bound, %: the bounds of the traced launches,
each at the frames still active at its step, over their traced time."""
from simbench import roofline
from simbench.bounds import list_layer


def read(run):
    return roofline.share(run, ("list_kernel", "list_general_kernel"),
                          list_layer.bound_ms)
