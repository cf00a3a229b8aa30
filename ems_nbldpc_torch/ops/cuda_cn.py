"""The EMS check node as a hand-written CUDA kernel.

The kernel of ``csrc/fb_checknode.cu`` replaces the JAX package's Pallas
kernel ``ops/pallas_cn.fb_checknode_pallas`` and the selections and
gathers around its call sites.  The decoder runs it for ``cn="ems"`` and
``"minsum"`` under every ``cn_impl`` but the bubble CNs: ``"pallas"`` (the
name is kept, so decoder configurations carry across unchanged),
``"auto"``, ``"topk"``, ``"dense"`` and ``"list"`` on dense storage, and
the compressed ``"topk"`` decoder (``decoder/flooding.k1_route``).  It
takes every row shape the plain version takes: rows of dc <= 2 (the
swapped pair, or the delta message) and rows too wide for a block's
shared memory (the library decides: in the dense mode, from dc = 20 at
q = 256), which run from a workspace in device memory that the wrapper
allocates from torch's caching allocator for each call (a CUDA graph's
capture takes it into its pool).  Two entry points launch it:

* ``ems_rows(x, rot_in, rot_out, valid, nm, offset, truncate, dense)``:
  the whole EMS check-node step of a batch of unrotated rows (truncate,
  rotate in, mask padding slots, F/B check node, rotate out, saturate,
  normalise); ``dense`` makes the check node the dense min-convolution
  (the kernel's dense mode, which merges whole vectors); ``ems_rows_plain``
  is its plain torch version.
* ``fb_checknode(vr, nm)``: the F/B check node alone on rotated float32
  or bfloat16 rows, the same kernel with the steps around it off; its
  plain version is ``minconv.fb_checknode_topk``.

On a CUDA tensor each wrapper launches the kernel or raises; there is no
fallback.  On a CPU tensor it runs the plain version, which the kernel
matches bit for bit.  The kernel is compiled with ``nvcc`` for ``sm_90a``
into ``ems_nbldpc_torch/build/`` at first use and loaded with ``ctypes``
(``ops/_build.py``).  ``launches`` counts the wrappers' eager kernel
launches (never plain calls; a stream capture records launches without
making them, and ``decoder/device_loop`` restores the count after its
capture).  ``device_launches()`` reads the count the kernel keeps itself
on the card: one per launch, a CUDA graph's replays included.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .minconv import (ems_input_truncate, ems_output_saturate,
                      fb_checknode_dense, fb_checknode_topk)

launches = 0  # eager kernel launches since import (set to 0 to count a run)


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("fb_checknode", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(build()[0])


def _bind(path: str) -> ctypes.CDLL:
    """Load the kernel library at ``path`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ems_rows_launch.argtypes = [
        ptr, ptr, i64, i32, i32, i32, ptr, ptr, ptr, i64,
        i32, i32, ctypes.c_float, i32, i32, ptr, i64, ptr,
    ]
    lib.ems_rows_launch.restype = i32
    lib.ems_rows_workspace_bytes.argtypes = [i64, i32, i32, i32, i32]
    lib.ems_rows_workspace_bytes.restype = i64
    lib.ems_rows_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.ems_rows_launches.restype = i32
    lib.ems_rows_reset_launches.argtypes = []
    lib.ems_rows_reset_launches.restype = i32
    return lib


def device_launches() -> int:
    """The kernel's launches on the current card since its library was
    loaded or ``reset_device_launches()``, counted by the kernel itself
    (one thread of its first block adds one), so the launches a CUDA
    graph replays count too.  Synchronises the card."""
    n = ctypes.c_ulonglong()
    err = _lib().ems_rows_launches(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"ems_rows: reading the launch count failed with "
                           f"CUDA error {err}")
    return n.value


def reset_device_launches() -> None:
    """Set ``device_launches()`` to 0.  Synchronises the card."""
    err = _lib().ems_rows_reset_launches()
    if err != 0:
        raise RuntimeError(f"ems_rows: resetting the launch count failed "
                           f"with CUDA error {err}")


def _check(x: torch.Tensor, nm: int, name: str,
           dtypes=(torch.float32,)) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: rows must be "
                        + " or ".join(str(d).split(".")[-1] for d in dtypes)
                        + f", got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: rows must be [T, dc, q], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")
    _, dc, q = x.shape
    if q < 2 or q > 256 or q & (q - 1):
        raise ValueError(f"{name}: q={q} must be a power of two <= 256")
    if dc < 1:
        raise ValueError(f"{name}: dc={dc} must be >= 1")
    if not 1 <= nm <= q:
        raise ValueError(f"{name}: nm={nm} must lie in [1, q={q}]")


def _table_rows(x, rot_in, rot_out, valid, name: str = "ems_rows") -> int:
    """Check the per-position tables against rows ``x`` [T, dc, q] and
    return their row count G (``name``: the caller, for the errors)."""
    _, dc, q = x.shape
    tables = [(n, t) for n, t in (("rot_in", rot_in), ("rot_out", rot_out),
                                  ("valid", valid)) if t is not None]
    if rot_in is None or rot_out is None:
        raise ValueError(f"{name}: rot_in and rot_out are required")
    g = rot_in.shape[0]
    for tab, t in tables:
        want = (g, dc) if tab == "valid" else (g, dc, q)
        dtype = torch.bool if tab == "valid" else torch.uint8
        if tuple(t.shape) != want or t.dtype != dtype:
            raise ValueError(f"{name}: {tab} must be {dtype} {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {tab} must be contiguous on "
                             f"{x.device}")
    if g < 1 or x.shape[0] % g:
        raise ValueError(f"{name}: T={x.shape[0]} rows are not a multiple "
                         f"of the tables' G={g} rows")
    return g


def ems_rows_plain(x, rot_in, rot_out, valid, nm: int, offset: float,
                   truncate: bool, dense: bool = False) -> torch.Tensor:
    """The plain torch composition that ``ems_rows`` fuses: [T, dc, q]
    unrotated rows -> [T, dc, q] min-normalised CN outputs; ``dense``: the
    dense min-convolution ``fb_checknode_dense`` in place of the nm-list
    ``fb_checknode_topk`` (the kernel's dense mode)."""
    t, dc, q = x.shape
    g = _table_rows(x, rot_in, rot_out, valid)
    v = x.reshape(t // g, g, dc, q)
    if truncate:
        v = ems_input_truncate(v, nm)
    v = torch.gather(v, -1, rot_in.long().expand_as(v))
    out = (fb_checknode_dense(v, valid) if dense
           else fb_checknode_topk(v, nm, valid))
    out = torch.gather(out, -1, rot_out.long().expand_as(out))
    if truncate:
        out = ems_output_saturate(out, nm, offset)
    out = out - out.min(dim=-1, keepdim=True).values
    return out.reshape(t, dc, q)


def _launch(x, nm, rot_in, rot_out, valid, g, truncate, normalize,
            offset, lst, round_bf16=False):
    global launches
    t, dc, q = x.shape
    out = torch.empty_like(x)
    if t == 0:
        return out

    def ptr(a):
        return None if a is None else a.data_ptr()

    lib = _lib()
    with torch.cuda.device(x.device):
        # rows past a block's shared memory run from a workspace
        nbytes = lib.ems_rows_workspace_bytes(t, dc, q, nm, lst)
        if nbytes < 0:
            raise RuntimeError(f"ems_rows: sizing the workspace failed with "
                               f"CUDA error {-nbytes}")
        ws = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
              if nbytes else None)
        err = lib.ems_rows_launch(
            x.data_ptr(), out.data_ptr(), t, dc, q, nm, ptr(rot_in),
            ptr(rot_out), ptr(valid), g, int(truncate), int(normalize),
            float(offset), lst, int(round_bf16), ptr(ws), nbytes,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ems_rows: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out


def ems_rows(x: torch.Tensor, rot_in, rot_out, valid, nm: int,
             offset: float, truncate: bool,
             dense: bool = False) -> torch.Tensor:
    """The EMS check-node step of a batch of rows, in one kernel launch
    (and, for rows past a block's shared memory, one allocation of its
    workspace).

    x: [T, dc, q] float32 unrotated, min-normalised VN-to-CN rows; row t
    uses row ``t % G`` of the per-position tables ``rot_in`` / ``rot_out``
    ([G, dc, q] uint8 gather tables, ``graph.rotation_table``) and of
    ``valid`` ([G, dc] bool, False at padding slots; None: no padding).
    ``truncate`` (``cn == "ems" and nm < q``) truncates the inputs to
    their nm best (ties with the nm-th kept) and saturates the outputs at
    nm-th best + ``offset``.  ``dense``: the check node is the dense
    min-convolution (nm is then the truncation rank alone).  Returns [T, dc, q] min-normalised outputs, equal bit for bit
    to ``ems_rows_plain``.
    """
    lst = x.shape[-1] if dense else nm
    _check(x, nm, "ems_rows")
    g = _table_rows(x, rot_in, rot_out, valid)
    if x.device.type == "cpu":
        return ems_rows_plain(x, rot_in, rot_out, valid, nm, offset,
                              truncate, dense)
    return _launch(x, nm, rot_in, rot_out, valid, g, truncate, True, offset,
                   lst)


def fb_checknode(vr: torch.Tensor, nm: int) -> torch.Tensor:
    """vr: [T, dc, q] rotated float32 or bfloat16 rows -> [T, dc, q] CN
    outputs of vr's dtype.  A bf16 input computes as
    ``fb_checknode_topk`` does on bf16 tensors: each merge's output
    rounded to bf16."""
    _check(vr, nm, "fb_checknode", dtypes=(torch.float32, torch.bfloat16))
    if vr.device.type == "cpu":
        return fb_checknode_topk(vr, nm)
    # null tables: identity rotations and no mask
    bf16 = vr.dtype == torch.bfloat16
    out = _launch(vr.float() if bf16 else vr, nm, None, None, None, 1,
                  False, False, 0.0, nm, bf16)
    return out.to(torch.bfloat16) if bf16 else out
