"""The syndrome-EMS check node as a hand-written CUDA kernel.

The kernel of ``csrc/syndrome_checknode.cu`` replaces the XLA sorts of
``ems_nbldpc_tpu/ops/syndrome_cn.syndrome_checknode`` and the top-k
selection and rotations around its call sites.  One entry point launches
it:

* ``syndrome_rows(x, rot_in, rot_out, valid, table, kth, nm, offset, bayes,
  presort)``: the whole syndrome check-node step of a batch of unrotated
  rows (rotate in, neutral padding slots, each edge's nm best, presort,
  config syndromes, per edge the decorrelated bucket minimum with bayes,
  the ``keep`` truncation and the saturation, rotate out, normalise);
  ``syndrome_rows_plain`` is its plain torch version, composed of
  ``ops/syndrome_cn``'s ops.

On a CUDA tensor the wrapper launches the kernel or raises; there is no
fallback.  On a CPU tensor it runs the plain version, which the kernel
matches bit for bit.  Configurations the kernel cannot hold (``check_fits``:
its shared memory, C, dc, nm, q) raise ``ValueError`` on either device.
The kernel is compiled with ``nvcc`` for ``sm_90a`` into
``ems_nbldpc_torch/build/`` at first use and loaded with ``ctypes``
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
from .cuda_cn import _table_rows
from .minconv import mask_invalid, topk_message
from .syndrome_cn import syndrome_cn_table

launches = 0  # eager kernel launches since import (set to 0 to count a run)

MAX_DC = 32          # the kernel's deviation masks are 32 bits
MAX_CONFIGS = 65536  # its bucket keys hold the config index in 16 bits
THREADS = 256        # one block of 256 threads per row, so q <= 256


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("syndrome_checknode", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.syndrome_rows_launch.argtypes = [
        ptr, ptr, i64, i32, i32, i32, ptr, ptr, ptr, i64, ptr, i32, ptr,
        i32, i32, ctypes.c_float, ptr,
    ]
    lib.syndrome_rows_launch.restype = i32
    lib.syndrome_rows_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.syndrome_rows_launches.restype = i32
    lib.syndrome_rows_reset_launches.argtypes = []
    lib.syndrome_rows_reset_launches.restype = i32
    return lib


def device_launches() -> int:
    """The kernel's launches on the current card since its library was
    loaded or ``reset_device_launches()``, counted by the kernel itself
    (one thread of its first block adds one), so the launches a CUDA graph
    replays count too.  Synchronises the card."""
    n = ctypes.c_ulonglong()
    err = _lib().syndrome_rows_launches(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"syndrome_rows: reading the launch count failed "
                           f"with CUDA error {err}")
    return n.value


def reset_device_launches() -> None:
    """Set ``device_launches()`` to 0.  Synchronises the card."""
    err = _lib().syndrome_rows_reset_launches()
    if err != 0:
        raise RuntimeError(f"syndrome_rows: resetting the launch count "
                           f"failed with CUDA error {err}")


def smem_bytes(dc: int, q: int, nm: int, c: int) -> int:
    """Shared memory of one block, i.e. one row (mirrors smem_bytes in the
    .cu source)."""
    def a16(b):
        return (b + 15) // 16 * 16
    return (2 * a16(4 * dc * q) + 4 * a16(4 * dc * nm) + 2 * a16(4 * c)
            + a16(2 * c) + a16(c) + 2 * a16(4 * q) + 2 * 4 * 256
            + a16(4 * MAX_DC) + 64)


def check_fits(dc: int, q: int, nm: int, c: int, presort: bool,
               name: str = "syndrome_rows") -> None:
    """Raise ``ValueError`` for a configuration the kernel cannot hold:
    q a power of two <= 256, 2 <= dc <= 32, 1 <= nm <= q (nm >= 3 with
    presort, which reads each edge's 3rd best), 1 <= C <= 65536 configs,
    and one row's shared memory within the block limit (232,448 bytes:
    about 20,000 configs at dc = 4, q = 256)."""
    if q < 2 or q > THREADS or q & (q - 1):
        raise ValueError(f"{name}: q={q} must be a power of two <= "
                         f"{THREADS}")
    if not 2 <= dc <= MAX_DC:
        raise ValueError(f"{name}: dc={dc} must lie in [2, {MAX_DC}]")
    if not (3 if presort else 1) <= nm <= q:
        raise ValueError(f"{name}: nm={nm} must lie in "
                         f"[{3 if presort else 1}, q={q}]"
                         + (" with presort" if presort else ""))
    if not 1 <= c <= MAX_CONFIGS:
        raise ValueError(f"{name}: C={c} configs, the kernel holds at most "
                         f"{MAX_CONFIGS}")
    need = smem_bytes(dc, q, nm, c)
    if need > _build.SMEM_LIMIT:
        raise ValueError(f"{name}: dc={dc}, q={q}, nm={nm}, C={c} configs "
                         f"need {need} B of shared memory per row, over the "
                         f"{_build.SMEM_LIMIT} B a block may use")


def _check(x, table, kth, nm, presort) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"syndrome_rows: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"syndrome_rows: rows must be float32, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"syndrome_rows: rows must be contiguous [T, dc, "
                         f"q], got {tuple(x.shape)}")
    t, dc, q = x.shape
    if table.dim() != 2 or table.shape[1] != dc or table.dtype != torch.uint8:
        raise ValueError(f"syndrome_rows: table must be uint8 [C, {dc}], "
                         f"got {table.dtype} {tuple(table.shape)}")
    if tuple(kth.shape) != (dc,) or kth.dtype != torch.int32:
        raise ValueError(f"syndrome_rows: kth must be int32 [{dc}], got "
                         f"{kth.dtype} {tuple(kth.shape)}")
    for name, tab in (("table", table), ("kth", kth)):
        if tab.device != x.device or not tab.is_contiguous():
            raise ValueError(f"syndrome_rows: {name} must be contiguous on "
                             f"{x.device}")
    if t >= 2 ** 31:
        raise ValueError(f"syndrome_rows: T={t} rows, at most 2^31 - 1")
    check_fits(dc, q, nm, table.shape[0], presort)


def syndrome_rows_plain(x, rot_in, rot_out, valid, table, kth, nm: int,
                        offset: float, bayes: bool,
                        presort: bool) -> torch.Tensor:
    """The plain torch composition that ``syndrome_rows`` fuses: [T, dc, q]
    unrotated rows -> [T, dc, q] min-normalised CN outputs."""
    t, dc, q = x.shape
    g = _table_rows(x, rot_in, rot_out, valid, "syndrome_rows")
    v = x.reshape(t // g, g, dc, q)
    vr = mask_invalid(torch.gather(v, -1, rot_in.long().expand_as(v)), valid)
    vals, gfs = topk_message(vr, nm)
    out = syndrome_cn_table(vals, gfs, q, table, kth, offset, bayes, presort)
    out = torch.gather(out, -1, rot_out.long().expand_as(out))
    out = out - out.min(dim=-1, keepdim=True).values
    return out.reshape(t, dc, q)


def syndrome_rows(x: torch.Tensor, rot_in, rot_out, valid,
                  table: torch.Tensor, kth: torch.Tensor, nm: int,
                  offset: float, bayes: bool, presort: bool) -> torch.Tensor:
    """The syndrome-EMS check-node step of a batch of rows, in one kernel
    launch.

    x: [T, dc, q] float32 unrotated, min-normalised VN-to-CN rows; row t
    uses row ``t % G`` of the per-position tables ``rot_in`` / ``rot_out``
    ([G, dc, q] uint8 gather tables, ``graph.rotation_table``) and of
    ``valid`` ([G, dc] bool, False at padding slots; None: no padding).
    ``table`` [C, dc] uint8 and ``kth`` [dc] int32 are the CN's static
    tables (``syndrome_cn.syndrome_tables``), shared by all rows; ``nm``
    the list length, ``bayes`` and ``presort`` its switches.  Returns
    [T, dc, q] min-normalised outputs, equal bit for bit to
    ``syndrome_rows_plain``.
    """
    _check(x, table, kth, nm, presort)
    g = _table_rows(x, rot_in, rot_out, valid, "syndrome_rows")
    if x.device.type == "cpu":
        return syndrome_rows_plain(x, rot_in, rot_out, valid, table, kth, nm,
                                   offset, bayes, presort)
    global launches
    t, dc, q = x.shape
    out = torch.empty_like(x)
    if t == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib().syndrome_rows_launch(
            x.data_ptr(), out.data_ptr(), t, dc, q, nm, rot_in.data_ptr(),
            rot_out.data_ptr(), None if valid is None else valid.data_ptr(),
            g, table.data_ptr(), table.shape[0], kth.data_ptr(), int(bayes),
            int(presort), float(offset),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"syndrome_rows: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out
