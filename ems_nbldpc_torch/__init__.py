"""PyTorch + CUDA port of the NB-LDPC EMS Monte-Carlo framework.

Mirrors the layout of the JAX package ``ems_nbldpc_tpu`` (the reference it
is tested against) module for module, so each port module sits at the
same relative path as its counterpart.  The port imports ``torch`` and
never ``jax``: the NumPy host layer (GF tables, parsers, code graph,
encoder) is carried as its own copy.

Ported so far: the CLI (``python -m ems_nbldpc_torch.cli``) and the Eb/N0
sweep, and the Monte-Carlo chain (bit-matmul encoder, the channels, the
decoder, the syndrome check and the error counters) on both schedules,
each decode as one CUDA graph with on-device early exit
(``loop="device"``, the default; ``decoder/device_loop.py``) or with the
host loop, with
- EMS / min-sum, dense f32 storage; ``cn_impl="pallas"`` selects the
  hand-written CUDA check node (``ops/cuda_cn.py``);
- SPA via the Walsh-Hadamard transform, dense f32 storage, through the
  hand-written CUDA SPA kernel (``ops/cuda_spa.py``) on the card: on the
  layered schedule the whole super-layer step in one launch;
- the syndrome-EMS check node (``cn="syndrome"``), dense f32 storage,
  its whole check-node step in one launch of a hand-written CUDA kernel
  (``ops/cuda_syndrome.py``) on the card;
- layered compressed CtoV storage, f32 or bf16: the dense-CN decoder and
  the truncated-list EMS path;
- every channel of the JAX package: BPSK/AWGN (a matmul demapper), 2-D
  QAM / rotated QAM / 64-APSK with Rayleigh or SSD fading and erasures,
  and the 256-QAM 4-D channel, their demappers one launch of a
  hand-written CUDA kernel (``ops/cuda_demap.py``) on the card;
- iteration-budget snapshots (``sim/snapshots.py``), decoder statistics
  (``decoder/stats.py``), two-phase decoding (``sim/twophase.py``),
  timers and ``torch.profiler`` traces (``utils/timing.py``), and frame
  sharding over ``torch.distributed``, one process per device
  (``parallel/mesh.py``; the CLI's ``--devices``).
"""

__version__ = "0.1.0"

from . import gf  # noqa: F401
from .decoder.api import DecoderConfig, decode  # noqa: F401
from .models import NBCode  # noqa: F401
from .sim.mc import MonteCarlo, SimConfig  # noqa: F401
