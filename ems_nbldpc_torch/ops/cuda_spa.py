"""The SPA check node as a hand-written CUDA kernel.

``spa_checknode(mvc, coefs, t_tab, tinv_tab)`` replaces the XLA op
``ems_nbldpc_tpu/ops/fht.fb_checknode_spa_fused``: the whole sum-product
check node of one ``[T, dc, q]`` batch of UN-rotated rows, with the GF
rotations folded into the Walsh-Hadamard transform.  The layered decoder
runs it for ``cn="spa"`` on every CUDA tensor.

* On a CUDA tensor the wrapper launches the kernel of
  ``csrc/spa_checknode.cu`` or raises; there is no fallback.
* On a CPU tensor it runs the plain version, ``fht.spa_checknode_plain``.
  The two agree to float rounding: the kernel's butterflies and the plain
  version's matrix products sum in different orders.

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
from .fht import position_tables, spa_checknode_plain

launches = 0  # kernel launches since import (reset it to 0 to count a run)


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("spa_checknode", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    lib.spa_checknode_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.spa_checknode_launch.restype = ctypes.c_int
    return lib


def smem_bytes(dc: int, q: int) -> int:
    """Shared memory of one block (mirrors the .cu source)."""
    return 4 * (2 * dc * q + dc * (max(q, 32) // 32))


def _check(mvc, coefs, t_tab, tinv_tab) -> None:
    if mvc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spa_checknode: unsupported device {mvc.device}")
    if mvc.dtype != torch.float32:
        raise TypeError(f"spa_checknode: mvc must be float32, got {mvc.dtype}")
    if mvc.dim() != 3:
        raise ValueError(f"spa_checknode: mvc must be [T, dc, q], got "
                         f"{tuple(mvc.shape)}")
    t, dc, q = mvc.shape
    if q < 2 or q > 256 or q & (q - 1):
        raise ValueError(f"spa_checknode: q={q} must be a power of two <= 256")
    if dc < 2:
        raise ValueError(f"spa_checknode: dc={dc} must be >= 2")
    if coefs.dtype != torch.int32 or coefs.dim() != 2 or coefs.shape[1] != dc:
        raise ValueError(f"spa_checknode: coefs must be [G, {dc}] int32, got "
                         f"{tuple(coefs.shape)} {coefs.dtype}")
    g = coefs.shape[0]
    if g == 0 or t % g:
        raise ValueError(f"spa_checknode: T={t} is not a multiple of G={g}")
    for name, tab in (("t_tab", t_tab), ("tinv_tab", tinv_tab)):
        if tab.dtype != torch.uint8 or tuple(tab.shape) != (q, q):
            raise ValueError(f"spa_checknode: {name} must be [{q}, {q}] "
                             f"uint8, got {tuple(tab.shape)} {tab.dtype}")
    for name, x in (("mvc", mvc), ("coefs", coefs), ("t_tab", t_tab),
                    ("tinv_tab", tinv_tab)):
        if x.device != mvc.device:
            raise ValueError(f"spa_checknode: {name} is on {x.device}, mvc "
                             f"on {mvc.device}")
        if not x.is_contiguous():
            raise ValueError(f"spa_checknode: {name} must be contiguous")
    if smem_bytes(dc, q) > _build.SMEM_LIMIT:
        raise ValueError(f"spa_checknode: dc={dc}, q={q} needs "
                         f"{smem_bytes(dc, q)} B of shared memory")


def spa_checknode(mvc: torch.Tensor, coefs: torch.Tensor,
                  t_tab: torch.Tensor, tinv_tab: torch.Tensor) -> torch.Tensor:
    """mvc: [T, dc, q] f32 UN-rotated rows, T = F*G; coefs: [G, dc] int32
    (row r uses coefs[r % G]; 0 = padding); t_tab, tinv_tab: the [q, q]
    uint8 ``fht.transpose_perm_tables`` -> [T, dc, q] f32 costs, min 0."""
    global launches
    _check(mvc, coefs, t_tab, tinv_tab)
    t, dc, q = mvc.shape
    g = coefs.shape[0]
    if mvc.device.type == "cpu":
        t_in, t_out = position_tables(coefs, t_tab, tinv_tab)
        return spa_checknode_plain(mvc.reshape(t // g, g, dc, q), t_in,
                                   t_out).reshape(t, dc, q)
    out = torch.empty_like(mvc)
    if t == 0:
        return out
    with torch.cuda.device(mvc.device):
        err = _lib().spa_checknode_launch(
            mvc.data_ptr(), coefs.data_ptr(), t_tab.data_ptr(),
            tinv_tab.data_ptr(), out.data_ptr(), t, g, dc, q,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"spa_checknode: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out
