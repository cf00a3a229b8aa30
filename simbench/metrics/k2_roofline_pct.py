"""K2 (``spa_row_kernel``, the fused SPA super-layer step) against its
roofline bound, %: the bounds of the traced launches, each at the frames
still active at its step, over their traced time."""
from simbench import roofline
from simbench.bounds import spa_layer


def read(run):
    return roofline.share(run, ("spa_row_kernel",), spa_layer.bound_ms)
