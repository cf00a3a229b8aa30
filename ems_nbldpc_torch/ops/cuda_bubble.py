"""The exact bubble check node as a hand-written CUDA kernel (K9).

The kernel of ``csrc/bubble_checknode.cu`` replaces the XLA ops of
``ems_nbldpc_tpu/ops/bubble_cn.py`` (the ``lax.fori_loop`` extract-min of
``_elementary``, ``elementary_bubble_batch``, ``fb_checknode_bubble``) and
the truncation, rotations, padding mask, saturation and normalisation
around its call sites.  The decoders select it with ``cn_impl="bubble"``
(the 8-bubble, ``variant="8"``) or ``"lbubble"`` (the L-bubble,
``variant="L"``).  Its entry point:

* ``bubble_rows(x, rot_in, rot_out, valid, nm, nb_oper, offset, truncate,
  saturate, variant)``: the whole bubble check-node step of a batch of
  unrotated rows, the call shape of ``cuda_cn.ems_rows``;
  ``bubble_cn.bubble_rows_plain`` is its plain torch version.

On a CUDA tensor the wrapper launches the kernel or raises; there is no
fallback.  On a CPU tensor it runs the plain version, which the kernel
matches bit for bit.  The kernel is compiled with ``nvcc`` for ``sm_90a``
into ``ems_nbldpc_torch/build/`` at first use and loaded with ``ctypes``
(``ops/_build.py``).  ``launches`` counts the wrapper's eager kernel
launches (never plain calls; ``decoder/device_loop`` restores the count
after its capture); ``device_launches()`` reads the count the kernel keeps
itself on the card, a CUDA graph's replays included.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .bubble_cn import bubble_rows_plain
from .cuda_cn import _table_rows

launches = 0  # eager kernel launches since import (set to 0 to count a run)

VARIANTS = {"8": 8, "L": 4}  # variant -> bubbles
MAX_ROWS = 64                # rows per tile (a block), as in the .cu source
WARPS = 4                    # warps per block
TWO_BLOCKS = 115000          # bytes a block may take for two to share an SM


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("bubble_checknode", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bubble_rows_launch.argtypes = [
        ptr, ptr, i64, i32, i32, i32, i32, ptr, ptr, ptr, i64, i32, i32,
        ctypes.c_float, i32, ptr,
    ]
    lib.bubble_rows_launch.restype = i32
    lib.bubble_rows_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.bubble_rows_launches.restype = i32
    lib.bubble_rows_reset_launches.argtypes = []
    lib.bubble_rows_reset_launches.restype = i32
    return lib


def device_launches() -> int:
    """The kernel's launches on the current card since its library was
    loaded or ``reset_device_launches()``, counted by the kernel itself
    (one thread of its first block adds one), so the launches a CUDA
    graph replays count too.  Synchronises the card."""
    n = ctypes.c_ulonglong()
    err = _lib().bubble_rows_launches(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"bubble_rows: reading the launch count failed "
                           f"with CUDA error {err}")
    return n.value


def reset_device_launches() -> None:
    """Set ``device_launches()`` to 0.  Synchronises the card."""
    err = _lib().bubble_rows_reset_launches()
    if err != 0:
        raise RuntimeError(f"bubble_rows: resetting the launch count failed "
                           f"with CUDA error {err}")


def smem_bytes(dc: int, q: int, nm: int, rows: int) -> int:
    """Shared memory of one block of ``rows`` rows (mirrors ``layout`` in
    the .cu source): 3 dc - 4 lists of nm (f32, int16) entries a row at an
    odd row stride, each warp's staging and list buffers, each thread's
    ``seen`` set."""
    def a16(b):
        return (b + 15) // 16 * 16
    entries = (3 * dc - 4) * nm * (rows | 1)
    words = q // 32 if q >= 32 else 1
    return (a16(4 * entries) + a16(2 * entries)
            + WARPS * a16(4 * 2 * q + 8 * 2 * nm) + 4 * words * 32 * WARPS)


def tile_rows(dc: int, q: int, nm: int) -> int:
    """Rows per block (mirrors ``tile_rows`` in the .cu source): as many
    as let two blocks share an SM, at most 64, else as many as one block
    holds; 0 if one row does not fit."""
    for limit in (TWO_BLOCKS, _build.SMEM_LIMIT):
        for rows in range(MAX_ROWS, 0, -1):
            if smem_bytes(dc, q, nm, rows) <= limit:
                return rows
    return 0


def _check(x: torch.Tensor, nm: int, nb_oper: int, variant: str) -> None:
    """Raise ``ValueError`` (``TypeError`` for a dtype) for what the kernel
    and its plain version do not take: rows other than contiguous float32
    [T, dc, q] with q a power of two <= 256 and dc >= 3, nm outside
    [1, q], a negative nb_oper, an unknown variant, or lists that do not
    fit one block's shared memory."""
    name = "bubble_rows"
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: rows must be float32, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: rows must be [T, dc, q], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")
    _, dc, q = x.shape
    if q < 2 or q > 256 or q & (q - 1):
        raise ValueError(f"{name}: q={q} must be a power of two <= 256")
    if dc < 3:
        raise ValueError(f"{name}: dc={dc} must be >= 3")
    if not 1 <= nm <= q:
        raise ValueError(f"{name}: nm={nm} must lie in [1, q={q}]")
    if nb_oper < 0:
        raise ValueError(f"{name}: nb_oper={nb_oper} must be >= 0")
    if variant not in VARIANTS:
        raise ValueError(f"{name}: variant={variant!r}: expected '8' or "
                         f"'L'")
    if tile_rows(dc, q, nm) < 1:
        raise ValueError(f"{name}: dc={dc}, q={q}, nm={nm} needs "
                         f"{smem_bytes(dc, q, nm, 1)} B of shared memory "
                         f"for one row")


def bubble_rows(x: torch.Tensor, rot_in, rot_out, valid, nm: int,
                nb_oper: int, offset: float, truncate: bool, saturate: bool,
                variant: str = "8") -> torch.Tensor:
    """The exact bubble check-node step of a batch of rows, in one kernel
    launch.

    x: [T, dc, q] float32 unrotated, min-normalised VN-to-CN rows; row t
    uses row ``t % G`` of the per-position tables ``rot_in`` / ``rot_out``
    ([G, dc, q] uint8 gather tables, ``graph.rotation_table``) and of
    ``valid`` ([G, dc] bool, False at padding slots; None: no padding).
    ``truncate`` (``cn == "ems"`` and nm < q) truncates the inputs to their
    nm best; ``saturate`` (the layered schedule's truncating CNs) applies
    ``ems_output_saturate`` to the outputs; ``nb_oper`` is the elementary
    steps' candidate budget; ``variant`` "8" or "L".  Returns [T, dc, q]
    min-normalised outputs, equal bit for bit to
    ``bubble_cn.bubble_rows_plain``.
    """
    global launches
    _check(x, nm, nb_oper, variant)
    g = _table_rows(x, rot_in, rot_out, valid, "bubble_rows")
    if x.device.type == "cpu":
        return bubble_rows_plain(x, rot_in, rot_out, valid, nm, nb_oper,
                                 offset, truncate, saturate, variant)
    t, dc, q = x.shape
    out = torch.empty_like(x)
    if t == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib().bubble_rows_launch(
            x.data_ptr(), out.data_ptr(), t, dc, q, nm, nb_oper,
            rot_in.data_ptr(), rot_out.data_ptr(),
            None if valid is None else valid.data_ptr(), g, int(truncate),
            int(saturate), float(offset), VARIANTS[variant],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bubble_rows: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out
