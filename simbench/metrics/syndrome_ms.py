"""Device time of the decoder's syndrome check a batch (``syndrome_ok``
over all frames, the state's update and the device loop's condition), ms:
from each decoder step's ``nbldpc_mark_syndrome`` kernel to the step's
closing ``set_condition``, summed over the steps of the traced batches."""
from ._marks import span_ms, steps


def read(run):
    return span_ms(run, "syndrome", "set_condition", steps)
