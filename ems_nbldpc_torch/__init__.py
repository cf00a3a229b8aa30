"""PyTorch + CUDA port of the NB-LDPC EMS Monte-Carlo framework.

Mirrors the layout of the JAX package ``ems_nbldpc_tpu`` (the reference it
is tested against) module for module, so each port module sits at the
same relative path as its counterpart.  The port imports ``torch`` and
never ``jax``: the NumPy host layer (GF tables, parsers, code graph,
encoder) is carried as its own copy.

Ported so far: the layered-EMS Monte-Carlo chain with dense f32 storage
and the host loop — bit-matmul encoder, BPSK/AWGN, the layered decoder
with ``cn="ems"`` and ``cn_impl`` in {"topk", "pallas", "auto"}, the
syndrome check and the error counters.  ``cn_impl="pallas"`` selects the
hand-written CUDA check-node kernel (``ops/cuda_cn.py``).
"""

__version__ = "0.1.0"

from . import gf  # noqa: F401
from .decoder.api import DecoderConfig, decode  # noqa: F401
from .models import NBCode  # noqa: F401
from .sim.mc import MonteCarlo, SimConfig  # noqa: F401
