"""The EMS check node as a hand-written CUDA kernel.

``fb_checknode(vr, nm)`` replaces the JAX package's Pallas kernel
``ops/pallas_cn.fb_checknode_pallas``: the whole forward/backward
nm-truncated check node of one ``[T, dc, q]`` batch of rotated rows.  The
decoder selects it with ``cn_impl="pallas"`` (the name is kept, so decoder
configurations carry across unchanged).

* On a CUDA tensor the wrapper launches the kernel of
  ``csrc/fb_checknode.cu`` or raises; there is no fallback.
* On a CPU tensor it runs the plain version, ``minconv.fb_checknode_topk``,
  which the kernel matches bit for bit.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into
``ems_nbldpc_torch/build/`` at first use and loaded with ``ctypes``
(``ops/_build.py``).  ``launches`` counts kernel launches (never plain
calls).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .minconv import fb_checknode_topk

launches = 0  # kernel launches since import (reset it to 0 to count a run)


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("fb_checknode", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    lib.fb_checknode_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fb_checknode_launch.restype = ctypes.c_int
    return lib


def smem_bytes(dc: int, q: int, nm: int) -> int:
    """Shared memory of one block (mirrors smem_bytes in the .cu source)."""
    return 4 * (2 * (dc - 1) * q + 4 * (dc - 2) * nm)


def _check(vr: torch.Tensor, nm: int) -> None:
    if vr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fb_checknode: unsupported device {vr.device}")
    if vr.dtype != torch.float32:
        raise TypeError(f"fb_checknode: vr must be float32, got {vr.dtype}")
    if vr.dim() != 3:
        raise ValueError(f"fb_checknode: vr must be [T, dc, q], got "
                         f"{tuple(vr.shape)}")
    if not vr.is_contiguous():
        raise ValueError("fb_checknode: vr must be contiguous")
    _, dc, q = vr.shape
    if q < 2 or q > 256 or q & (q - 1):
        raise ValueError(f"fb_checknode: q={q} must be a power of two <= 256")
    if dc < 3:
        raise ValueError(f"fb_checknode: dc={dc} must be >= 3")
    if not 1 <= nm <= q:
        raise ValueError(f"fb_checknode: nm={nm} must lie in [1, q={q}]")
    if smem_bytes(dc, q, nm) > _build.SMEM_LIMIT:
        raise ValueError(f"fb_checknode: dc={dc}, q={q}, nm={nm} needs "
                         f"{smem_bytes(dc, q, nm)} B of shared memory")


def fb_checknode(vr: torch.Tensor, nm: int) -> torch.Tensor:
    """vr: [T, dc, q] rotated float32 rows -> [T, dc, q] CN outputs."""
    global launches
    _check(vr, nm)
    if vr.device.type == "cpu":
        return fb_checknode_topk(vr, nm)
    t, dc, q = vr.shape
    out = torch.empty_like(vr)
    if t == 0:
        return out
    with torch.cuda.device(vr.device):
        err = _lib().fb_checknode_launch(
            vr.data_ptr(), out.data_ptr(), t, dc, q, nm,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fb_checknode: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out
