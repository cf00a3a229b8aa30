"""Device time of the encoder a batch (``MonteCarlo.gen``'s info bits,
the f32 GEMM against the bit generator, the symbol packing), ms: from the
program's ``nbldpc_mark_encode`` kernel to its ``nbldpc_mark_channel``, in
the traced batches."""
from ._marks import once, span_ms


def read(run):
    return span_ms(run, "encode", "channel", once)
