"""The exact bubble check node as a hand-written CUDA kernel (K9), and the
layered bubble super-layer step around it.

The kernel of ``csrc/bubble_checknode.cu`` replaces the XLA ops of
``ems_nbldpc_tpu/ops/bubble_cn.py`` (the ``lax.fori_loop`` extract-min of
``_elementary``, ``elementary_bubble_batch``, ``fb_checknode_bubble``) and
the truncation, rotations, padding mask, saturation, normalisation,
gathers and write-back around its call sites.  The decoders select it with
``cn_impl="bubble"`` (the 8-bubble, ``variant="8"``) or ``"lbubble"`` (the
L-bubble, ``variant="L"``).  Two entry points launch it:

* ``bubble_layer(app, ctov, active, cols, edges, rot_in, rot_out, valid,
  nm, nb_oper, offset, truncate, saturate, variant)``: one super-layer of
  the layered sweep, in place on the decoder state (gathers, VN extrinsic
  and its normalisation, check node, freeze of converged frames,
  write-back of the real slots); ``bubble_layer_plain`` is its plain torch
  version.  The layered decoder runs it.  The state is float32 or
  bfloat16 (``cuda_spa.STATE_DTYPES``): a bf16 state is widened to f32
  where it is read, the step computes in f32, and each store rounds once
  to nearest even, on both sides, so they agree bit for bit at either
  dtype.
* ``bubble_rows(x, rot_in, rot_out, valid, nm, nb_oper, offset, truncate,
  saturate, variant)``: the whole bubble check-node step of a batch of
  unrotated rows, the call shape of ``cuda_cn.ems_rows``;
  ``bubble_cn.bubble_rows_plain`` is its plain torch version.  The
  flooding decoder runs it.

On a CUDA tensor each wrapper launches the kernel or raises; there is no
fallback.  On a CPU tensor it runs the plain version, which the kernel
matches bit for bit.  The kernel is compiled with ``nvcc`` for ``sm_90a``
into ``ems_nbldpc_torch/build/`` at first use and loaded with ``ctypes``
(``ops/_build.py``).  ``launches`` counts the wrappers' eager kernel
launches of both entries, ``layer_launches`` those of ``bubble_layer``
(never plain calls; ``decoder/device_loop`` restores the counts after its
capture); ``device_launches()`` reads the counts the kernel keeps itself on
the card, a CUDA graph's replays included.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .bubble_cn import bubble_rows_plain
from .cuda_cn import _table_rows
from .cuda_spa import check_state

launches = 0  # eager kernel launches since import (set to 0 to count a run)
layer_launches = 0  # the part of ``launches`` made by ``bubble_layer``

VARIANTS = {"8": 8, "L": 4}  # variant -> bubbles
WARPS = 4                    # warps per block
MAX_ROWS = 16                # rows a warp holds (two chain lanes a row)
TARGET_WARPS = 16            # warps an SM the rows per warp aim at
SM_SMEM = 233472             # shared memory of an SM
BLOCK_RESERVED = 1024        # the system's share of it a block takes
# the layer entry's C function by state dtype (``cuda_spa.STATE_DTYPES``)
_LAYER_ENTRY = {torch.float32: "bubble_layer_launch",
                torch.bfloat16: "bubble_layer_bf16_launch"}


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("bubble_checknode", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build()[0])


def bind(path: str) -> ctypes.CDLL:
    """Load the kernel library at ``path`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cn = [i32, i32, i32, i32, ptr, ptr, ptr, i64, i32, i32, ctypes.c_float,
          i32, ptr]
    lib.bubble_rows_launch.argtypes = [ptr, ptr, i64] + cn
    lib.bubble_rows_launch.restype = i32
    # a variant source (chip_variants.py) may lack the bf16 entry
    for name in _LAYER_ENTRY.values():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, i64, i64, i64, ptr, ptr, ptr] + cn
            fn.restype = i32
    lib.bubble_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.bubble_launches.restype = i32
    lib.bubble_reset_launches.argtypes = []
    lib.bubble_reset_launches.restype = i32
    return lib


def device_launches() -> tuple[int, int]:
    """(launches of both entries, the part made by ``bubble_layer``) of the
    kernel on the current card since its library was loaded or
    ``reset_device_launches()``, counted by the kernel itself (one thread
    of its first block adds one), so the launches a CUDA graph replays
    count too.  Synchronises the card."""
    n = (ctypes.c_ulonglong * 2)()
    err = _lib().bubble_launches(n)
    if err != 0:
        raise RuntimeError(f"bubble_rows: reading the launch counts failed "
                           f"with CUDA error {err}")
    return n[0] + n[1], n[1]


def reset_device_launches() -> None:
    """Set ``device_launches()`` to (0, 0).  Synchronises the card."""
    err = _lib().bubble_reset_launches()
    if err != 0:
        raise RuntimeError(f"bubble_rows: resetting the launch counts failed "
                           f"with CUDA error {err}")


def warp_bytes(dc: int, q: int, nm: int, rows: int) -> int:
    """Shared memory of one warp holding ``rows`` rows (mirrors ``layout``
    in the .cu source): the staging buffer (one message, or the
    bisection's nm sort keys), the 3 dc - 4 lists of nm (f32, uint8)
    entries a row and their uint16 counts, each lane's ``seen`` set."""
    def a16(b):
        return (b + 15) // 16 * 16
    lists = 3 * dc - 4
    entries = lists * nm * rows
    words = q // 32 if q >= 32 else 1
    return (a16(8 * q) + a16(4 * entries) + a16(entries)
            + a16(2 * lists * rows) + 4 * words * 32)


def rows_per_warp(dc: int, q: int, nm: int) -> int:
    """Rows a warp holds (mirrors ``rows_per_warp`` in the .cu source): as
    many, at most 16, as let 16 warps share an SM, else 1 if one warp of
    one row fits a block (blocks then take fewer than four warps); 0 if
    not even that."""
    budget = (SM_SMEM - BLOCK_RESERVED * (TARGET_WARPS // WARPS)) \
        // TARGET_WARPS
    for rows in range(MAX_ROWS, 0, -1):
        if warp_bytes(dc, q, nm, rows) <= budget:
            return rows
    return 1 if warp_bytes(dc, q, nm, 1) <= _build.SMEM_LIMIT else 0


def _check_cn(name: str, dc: int, q: int, nm: int, nb_oper: int,
              variant: str) -> None:
    """Raise ``ValueError`` for a CN the kernel and its plain versions do
    not take: q not a power of two <= 256, dc < 3, nm outside [1, q], a
    negative nb_oper, an unknown variant, or lists that do not fit one
    block's shared memory."""
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
    if rows_per_warp(dc, q, nm) < 1:
        raise ValueError(f"{name}: dc={dc}, q={q}, nm={nm} needs "
                         f"{warp_bytes(dc, q, nm, 1)} B of shared memory "
                         f"for one row, over the {_build.SMEM_LIMIT} B a "
                         f"block may use")


def _check(x: torch.Tensor, nm: int, nb_oper: int, variant: str) -> None:
    """Raise ``ValueError`` (``TypeError`` for a dtype) for rows other than
    contiguous float32 [T, dc, q] on the CPU or a CUDA card, or a CN that
    ``_check_cn`` refuses."""
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
    _check_cn(name, x.shape[1], x.shape[2], nm, nb_oper, variant)


def _cn_args(nm, nb_oper, rot_in, rot_out, valid, g, truncate, saturate,
             offset, variant):
    """The launchers' shared arguments after the rows' own."""
    return (rot_in.shape[1], rot_in.shape[2], nm, nb_oper,
            rot_in.data_ptr(), rot_out.data_ptr(),
            None if valid is None else valid.data_ptr(), g, int(truncate),
            int(saturate), float(offset), VARIANTS[variant],
            torch.cuda.current_stream().cuda_stream)


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
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib().bubble_rows_launch(
            x.data_ptr(), out.data_ptr(), x.shape[0],
            *_cn_args(nm, nb_oper, rot_in, rot_out, valid, g, truncate,
                      saturate, offset, variant))
    if err != 0:
        raise RuntimeError(f"bubble_rows: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out


def _check_layer(app, ctov, active, cols, edges, rot_in, rot_out, valid, nm,
                 nb_oper, variant) -> None:
    """Raise ``ValueError`` (``TypeError`` for the state's dtype) for a
    layer the kernel and its plain version do not take."""
    name = "bubble_layer"
    if app.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {app.device}")
    check_state(name, app, ctov)
    for key, x in (("app", app), ("ctov", ctov)):
        if x.dim() != 3:
            raise ValueError(f"{name}: {key} must be [F, rows, q], got "
                             f"{tuple(x.shape)}")
        if x.device != app.device:
            raise ValueError(f"{name}: {key} is on {x.device}, app on "
                             f"{app.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    f, _, q = app.shape
    if ctov.shape[0] != f or ctov.shape[2] != q:
        raise ValueError(f"{name}: ctov {tuple(ctov.shape)} does not match "
                         f"app {tuple(app.shape)}")
    if (active.dtype != torch.bool or tuple(active.shape) != (f,)
            or active.device != app.device or not active.is_contiguous()):
        raise ValueError(f"{name}: active must be [{f}] bool on "
                         f"{app.device}, got {tuple(active.shape)} "
                         f"{active.dtype} on {active.device}")
    if cols.dim() != 2 or cols.dtype != torch.int32:
        raise ValueError(f"{name}: cols must be [G, dc] int32, got "
                         f"{tuple(cols.shape)} {cols.dtype}")
    g, dc = cols.shape
    if edges.dtype != torch.int32 or tuple(edges.shape) != (g, dc):
        raise ValueError(f"{name}: edges must be [{g}, {dc}] int32, got "
                         f"{tuple(edges.shape)} {edges.dtype}")
    for key, x in (("cols", cols), ("edges", edges)):
        if x.device != app.device or not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on "
                             f"{app.device}")
    if g == 0:
        raise ValueError(f"{name}: the tables have no rows")
    for key, tab, want, dtype in (
            ("rot_in", rot_in, (g, dc, q), torch.uint8),
            ("rot_out", rot_out, (g, dc, q), torch.uint8),
            ("valid", valid, (g, dc), torch.bool)):
        if tab is None and key == "valid":
            continue
        if tab is None or tuple(tab.shape) != want or tab.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {dtype} {want}, got "
                             + ("None" if tab is None else
                                f"{tab.dtype} {tuple(tab.shape)}"))
        if tab.device != app.device or not tab.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on "
                             f"{app.device}")
    if f * g >= 2 ** 62:
        raise ValueError(f"{name}: F*G = {f * g} rows is too many")
    _check_cn(name, dc, q, nm, nb_oper, variant)


def bubble_layer_plain(app, ctov, active, cols, edges, rot_in, rot_out,
                       valid, nm: int, nb_oper: int, offset: float,
                       truncate: bool, saturate: bool,
                       variant: str = "8") -> None:
    """The plain torch super-layer step that ``bubble_layer`` fuses, in
    place: gathers (widened to f32), VN extrinsic minus its min,
    ``bubble_rows_plain``, and the write-back of the real slots of active
    frames, rounded to the state's dtype (a frozen frame or padded slot
    writes back what it read)."""
    cols, edges = cols.long(), edges.long()
    app_rows = app[:, cols].float()                   # [F, G, dc, q]
    ctov_rows = ctov[:, edges].float()
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    f, g, dc, q = mvc.shape
    mcv = bubble_rows_plain(mvc.reshape(f * g, dc, q), rot_in, rot_out,
                            valid, nm, nb_oper, offset, truncate, saturate,
                            variant).reshape(mvc.shape)
    write = active[:, None, None, None]
    if valid is not None:
        write = write & valid[None, :, :, None]
    ctov[:, edges] = torch.where(write, mcv, ctov_rows).to(ctov.dtype)
    app[:, cols] = torch.where(write, mvc + mcv, app_rows).to(app.dtype)


def bubble_layer(app: torch.Tensor, ctov: torch.Tensor, active: torch.Tensor,
                 cols: torch.Tensor, edges: torch.Tensor,
                 rot_in: torch.Tensor, rot_out: torch.Tensor, valid,
                 nm: int, nb_oper: int, offset: float, truncate: bool,
                 saturate: bool, variant: str = "8") -> None:
    """One layered bubble super-layer, in place, in one kernel launch.

    app: [F, N+1, q] and ctov: [F, E+1, q] contiguous state of one dtype,
    float32 or bfloat16 (a bf16 state is widened to f32 where read and
    rounded to nearest even where written); active: [F] bool (False:
    converged, left untouched); cols, edges: the
    layer's [G, dc] int32 APP columns and CtoV edges (padding slots at
    column N and edge E; the layer's other columns and edges are distinct;
    on the card an index out of range is a device-side fault, as in
    torch's own index kernels); rot_in, rot_out: its [G, dc, q] uint8
    rotation tables; valid: [G, dc] bool (False at padding slots) or None;
    nm, nb_oper, offset, truncate, saturate, variant: as ``bubble_rows``.
    For each active frame and row: mvc = APP[cols] - CtoV[edges] minus its
    min, mcv = ``bubble_rows`` of mvc, then, on the real slots,
    CtoV[edges] = mcv and APP[cols] = mvc + mcv.  Padded slots write
    nothing, so the padding column and edge keep their values.  Equal bit
    for bit to ``bubble_layer_plain``.
    """
    global launches, layer_launches
    _check_layer(app, ctov, active, cols, edges, rot_in, rot_out, valid, nm,
                 nb_oper, variant)
    if app.device.type == "cpu":
        bubble_layer_plain(app, ctov, active, cols, edges, rot_in, rot_out,
                           valid, nm, nb_oper, offset, truncate, saturate,
                           variant)
        return
    f = app.shape[0]
    if f == 0:
        return
    with torch.cuda.device(app.device):
        err = getattr(_lib(), _LAYER_ENTRY[app.dtype])(
            app.data_ptr(), ctov.data_ptr(), f, app.shape[1], ctov.shape[1],
            active.data_ptr(), cols.data_ptr(), edges.data_ptr(),
            *_cn_args(nm, nb_oper, rot_in, rot_out, valid, cols.shape[0],
                      truncate, saturate, offset, variant))
    if err != 0:
        raise RuntimeError(f"bubble_layer: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    layer_launches += 1
