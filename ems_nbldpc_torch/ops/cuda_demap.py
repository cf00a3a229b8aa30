"""The 2-D and 4-D demappers as a hand-written CUDA kernel (K8).

The kernel of ``csrc/demap.cu`` replaces the XLA ops of
``ems_nbldpc_tpu/models/channels.py`` ``channel_2d`` (the distance to every
point, ``:251-258``) and ``qam256_4d`` (its two products against the table,
``:335-342``): per received symbol the cost of each of the q constellation
points, min-normalised, written once as [F, N, q] f32.  Two entry points:

* ``demap_2d(y, att, pts, inv)``: the direct form of
  ``models/channels.demap_2d_plain`` (D = 2);
* ``demap_4d(y, att, cand, inv)``: the expanded form of
  ``models/channels.demap_4d_plain`` (D = 4).

On a CUDA tensor each wrapper launches the kernel or raises; there is no
fallback.  On a CPU tensor it runs the plain version.  The kernel rounds
each operation as the plain version does and equals it bit for bit.  It is
compiled with ``nvcc`` for ``sm_90a`` into ``ems_nbldpc_torch/build/`` at
first use and loaded with ``ctypes`` (``ops/_build.py``).  ``launches``
counts the wrappers' kernel launches (never plain calls);
``device_launches()`` reads the count the kernel keeps itself on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..models.channels import demap_2d_plain, demap_4d_plain

launches = 0  # kernel launches since import (set to 0 to count a run)


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("demap", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.demap_launch.argtypes = [ptr, ptr, ptr, ctypes.c_float, ptr, i64,
                                 i32, i32, ptr]
    lib.demap_launch.restype = i32
    lib.demap_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.demap_launches.restype = i32
    lib.demap_reset_launches.argtypes = []
    lib.demap_reset_launches.restype = i32
    return lib


def device_launches() -> int:
    """The kernel's launches on the current card since its library was
    loaded or ``reset_device_launches()``, counted by the kernel itself.
    Synchronises the card."""
    n = ctypes.c_ulonglong(0)
    err = _lib().demap_launches(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"demap: reading the launch count failed with "
                           f"CUDA error {err}")
    return n.value


def reset_device_launches() -> None:
    """Set ``device_launches()`` to 0.  Synchronises the card."""
    err = _lib().demap_reset_launches()
    if err != 0:
        raise RuntimeError(f"demap: resetting the launch count failed with "
                           f"CUDA error {err}")


def _check(name, dims, y, att, table) -> None:
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {y.device}")
    for key, x in (("y", y), ("att", att), ("table", table)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32, got {x.dtype}")
        if x.device != y.device:
            raise ValueError(f"{name}: {key} is on {x.device}, y on "
                             f"{y.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if y.dim() < 1 or y.shape[-1] != dims or att.shape != y.shape:
        raise ValueError(f"{name}: y and att must be [..., {dims}] of one "
                         f"shape, got {tuple(y.shape)} and "
                         f"{tuple(att.shape)}")
    if table.dim() != 2 or table.shape[1] != dims:
        raise ValueError(f"{name}: table must be [q, {dims}], got "
                         f"{tuple(table.shape)}")
    q = table.shape[0]
    if q < 2 or q > 256 or q & (q - 1):
        raise ValueError(f"{name}: q={q} must be a power of two in 2..256")


def _demap(name, dims, plain, y, att, table, inv):
    global launches
    _check(name, dims, y, att, table)
    if y.device.type == "cpu":
        return plain(y, att, table, inv)
    q = table.shape[0]
    out = torch.empty((*y.shape[:-1], q), dtype=torch.float32,
                      device=y.device)
    rows = out.numel() // q
    if rows == 0:
        return out
    with torch.cuda.device(y.device):
        err = _lib().demap_launch(
            y.data_ptr(), att.data_ptr(), table.data_ptr(), inv,
            out.data_ptr(), rows, dims, q,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return out


def demap_2d(y: torch.Tensor, att: torch.Tensor, pts: torch.Tensor,
             inv: float) -> torch.Tensor:
    """y, att: [..., 2] f32; pts: [q, 2] f32; inv: float32(1 / (2 sigma^2))
    -> [..., q] f32 costs (sum_d (y_d - a_d x_gd)^2) * inv, minus their
    min."""
    return _demap("demap_2d", 2, demap_2d_plain, y, att, pts, inv)


def demap_4d(y: torch.Tensor, att: torch.Tensor, cand: torch.Tensor,
             inv: float) -> torch.Tensor:
    """y, att: [..., 4] f32; cand: [q, 4] f32 -> [..., q] f32 costs
    (sum_d a_d^2 x_gd^2 - 2 sum_d (a_d y_d) x_gd) * inv, minus their min."""
    return _demap("demap_4d", 4, demap_4d_plain, y, att, cand, inv)
