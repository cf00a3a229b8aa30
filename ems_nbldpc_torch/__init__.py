"""PyTorch + CUDA port of the NB-LDPC EMS Monte-Carlo framework.

Mirrors the layout of the JAX package ``ems_nbldpc_tpu`` (the reference it
is tested against) module for module, so each port module sits at the
same relative path as its counterpart.  The port imports ``torch`` and
never ``jax``: the NumPy host layer (GF tables, parsers, code graph,
encoder) is carried as its own copy.

Ported so far, all on the layered schedule with the host loop: the
Monte-Carlo chain (bit-matmul encoder, BPSK/AWGN, the decoder, the
syndrome check and the error counters) with
- EMS, dense f32 storage, ``cn_impl`` in {"topk", "pallas", "auto"};
  ``"pallas"`` selects the hand-written CUDA check node (``ops/cuda_cn.py``);
- SPA via the Walsh-Hadamard transform, dense f32 storage, through the
  hand-written CUDA SPA kernel (``ops/cuda_spa.py``) on the card: on the
  layered schedule the whole super-layer step in one launch;
- truncated-list EMS with compressed CtoV storage, f32 or bf16.
"""

__version__ = "0.1.0"

from . import gf  # noqa: F401
from .decoder.api import DecoderConfig, decode  # noqa: F401
from .models import NBCode  # noqa: F401
from .sim.mc import MonteCarlo, SimConfig  # noqa: F401
