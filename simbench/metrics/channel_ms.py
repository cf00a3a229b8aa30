"""Device time of the channel a batch (BPSK, the noise and the demapper
that makes the intrinsic costs), ms: from the program's
``nbldpc_mark_channel`` kernel to its ``nbldpc_mark_end`` at the end of
``MonteCarlo.gen``, in the traced batches; what the harness runs after
gen is not in it."""
from ._marks import once, span_ms


def read(run):
    return span_ms(run, "channel", "end", once)
