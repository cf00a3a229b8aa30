"""The syndrome-EMS check node as a hand-written CUDA kernel, and the
layered syndrome super-layer step around it.

The kernel of ``csrc/syndrome_checknode.cu`` replaces the XLA sorts of
``ems_nbldpc_tpu/ops/syndrome_cn.syndrome_checknode`` and the top-k
selection, rotations, gathers and write-back around its call sites.  Two
entry points launch it:

* ``syndrome_layer(app, ctov, active, cols, edges, rot_in, rot_out, valid,
  table, kth, nm, offset, bayes, presort)``: one super-layer of the layered
  sweep, in place on the decoder state (gathers, VN extrinsic and its
  normalisation, check node, freeze of converged frames, write-back of the
  real slots); ``syndrome_layer_plain`` is its plain torch version.  The
  layered decoder runs it for ``cn="syndrome"``.  The state is float32 or
  bfloat16 (``cuda_spa.STATE_DTYPES``): a bf16 state is widened to f32
  where it is read, the step computes in f32, and each store rounds once
  to nearest even, on both sides, so they agree bit for bit at either
  dtype.
* ``syndrome_rows(x, rot_in, rot_out, valid, table, kth, nm, offset, bayes,
  presort)``: the whole syndrome check-node step of a batch of unrotated
  rows (rotate in, neutral padding slots, each edge's nm best, presort,
  config syndromes, per edge the decorrelated bucket minimum with bayes,
  the ``keep`` truncation and the saturation, rotate out, normalise);
  ``syndrome_rows_plain`` is its plain torch version, composed of
  ``ops/syndrome_cn``'s ops.  The flooding decoder runs it.

Both take the per-position lists of the configs with no deviation there
(``position_lists``, built and checked once on the host; ``lists=None``
builds them from the table, which reads it on the host).  On a CUDA tensor
each wrapper launches the kernel or raises; there is no fallback.  On a
CPU tensor it runs the plain version, which the kernel matches bit for
bit.  Configurations the kernel cannot hold (``check_fits``: one warp's
shared memory, C, dc, nm, q) and tables it would misread (``position_lists``:
a deviation >= nm, a saturation rank past its position's configs) raise
``ValueError`` on either device.  The kernel is compiled with ``nvcc`` for
``sm_90a`` into ``ems_nbldpc_torch/build/`` at first use and loaded with
``ctypes`` (``ops/_build.py``).  ``launches`` counts the wrappers' eager
kernel launches of both entries, ``layer_launches`` those of
``syndrome_layer`` (never plain calls; ``decoder/device_loop`` restores the
counts after its capture); ``device_launches()`` reads the counts the kernel
keeps itself on the card, a CUDA graph's replays included.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .cuda_cn import _table_rows
from .cuda_spa import check_state
from .minconv import mask_invalid, topk_message
from .syndrome_cn import syndrome_cn_table

launches = 0  # eager kernel launches since import (set to 0 to count a run)
layer_launches = 0  # the part of ``launches`` made by ``syndrome_layer``

MAX_DC = 32          # the presort ranks one edge a lane
MAX_Q = 256          # GF ids and bucket ids are bytes
MAX_CONFIGS = 65536  # the bucket keys hold the config index in 16 bits
REG_CONFIGS = 512    # masked configs of a position the warp's registers hold
# the layer entry's C function by state dtype (``cuda_spa.STATE_DTYPES``)
_LAYER_ENTRY = {torch.float32: "syndrome_layer_launch",
                torch.bfloat16: "syndrome_layer_bf16_launch"}


class PositionLists(NamedTuple):
    """Per presorted edge position t, the configs with no deviation on t
    (ascending), as the kernel reads them: ``configs[offsets[t]:offsets[t +
    1]]`` (uint16 ids stored as int16).  ``counts``, ``nm`` and
    ``n_configs`` are host copies, so that a launch reads nothing back."""
    offsets: torch.Tensor   # [dc + 1] int32
    configs: torch.Tensor   # [sum of counts] int16
    counts: tuple
    nm: int
    n_configs: int


def position_lists(table, kth, nm: int, device=None) -> PositionLists:
    """Check a config table [C, dc] and its saturation ranks [dc] (NumPy
    arrays or tensors, read on the host) for list length ``nm``, and build
    their ``PositionLists`` on ``device``.  Raises ``ValueError`` where the
    kernel would misread them: a deviation >= nm (no such list entry), a
    rank kth[t] outside [0, count of position t), or C outside
    [1, 65536]."""
    cfg = np.asarray(table.cpu() if torch.is_tensor(table) else table)
    ranks = np.asarray(kth.cpu() if torch.is_tensor(kth) else kth,
                       np.int64).reshape(-1)
    if cfg.ndim != 2 or ranks.shape[0] != cfg.shape[1]:
        raise ValueError(f"position_lists: table {cfg.shape} and kth "
                         f"{ranks.shape} do not match")
    c = cfg.shape[0]
    if not 1 <= c <= MAX_CONFIGS:
        raise ValueError(f"syndrome tables: C={c} configs, the kernel holds "
                         f"1 to {MAX_CONFIGS}")
    if cfg.size and (cfg.min() < 0 or cfg.max() >= nm):
        raise ValueError(f"syndrome tables: deviations must lie in "
                         f"[0, nm={nm}), got [{cfg.min()}, {cfg.max()}]")
    lists = [np.flatnonzero(cfg[:, t] == 0) for t in range(cfg.shape[1])]
    counts = tuple(len(x) for x in lists)
    for t, (k, n) in enumerate(zip(ranks, counts)):
        if not 0 <= k < n:
            raise ValueError(f"syndrome tables: kth[{t}]={k} must lie in "
                             f"[0, {n}), the configs with no deviation on "
                             f"position {t}")
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    configs = np.concatenate(lists).astype(np.uint16).view(np.int16)
    return PositionLists(torch.as_tensor(offsets, device=device),
                         torch.as_tensor(configs, device=device), counts,
                         int(nm), c)


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("syndrome_checknode", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build()[0])


def bind(path: str) -> ctypes.CDLL:
    """Load the kernel library at ``path`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    tables = [ptr, ptr, ptr, i32, ptr, i32, ptr, ptr, ptr, i32, i32, i32, f32,
              ptr]
    lib.syndrome_rows_launch.argtypes = [ptr, ptr, i64, i32, i32, i32] + tables
    lib.syndrome_rows_launch.restype = i32
    # a variant source (chip_variants.py) may lack the bf16 entry
    for name in _LAYER_ENTRY.values():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, i64, i64, i64, ptr, ptr, ptr, i32, i32,
                           i32] + tables
            fn.restype = i32
    lib.syndrome_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.syndrome_launches.restype = i32
    lib.syndrome_reset_launches.argtypes = []
    lib.syndrome_reset_launches.restype = i32
    return lib


def device_launches() -> tuple[int, int]:
    """(launches of both entries, the part made by ``syndrome_layer``) of
    the kernel on the current card since its library was loaded or
    ``reset_device_launches()``, counted by the kernel itself (one thread
    of its first block adds one), so the launches a CUDA graph replays
    count too.  Synchronises the card."""
    n = (ctypes.c_ulonglong * 2)()
    err = _lib().syndrome_launches(n)
    if err != 0:
        raise RuntimeError(f"syndrome_rows: reading the launch counts failed "
                           f"with CUDA error {err}")
    return n[0] + n[1], n[1]


def reset_device_launches() -> None:
    """Set ``device_launches()`` to (0, 0).  Synchronises the card."""
    err = _lib().syndrome_reset_launches()
    if err != 0:
        raise RuntimeError(f"syndrome_rows: resetting the launch counts "
                           f"failed with CUDA error {err}")


def smem_bytes(dc: int, q: int, nm: int, c: int,
               max_masked: int | None = None) -> int:
    """Shared memory of one warp, i.e. one row in flight (mirrors layout in
    the .cu source); ``max_masked``: the largest count of a position's
    masked configs (None: C, the most it can be)."""
    def a16(b):
        return (b + 15) // 16 * 16
    lists = 8 * dc * nm
    spill = (c if max_masked is None else max_masked) - REG_CONFIGS
    return (a16(4 * dc * q) + a16(lists) + a16(max(lists, 4 * q, 256))
            + a16(4 * c) + 2 * a16(4 * q) + a16(4 * dc)
            + a16(2 * max(spill, 0)))


def check_fits(dc: int, q: int, nm: int, c: int, presort: bool,
               name: str = "syndrome_rows",
               max_masked: int | None = None) -> None:
    """Raise ``ValueError`` for a configuration the kernel cannot hold:
    q a power of two <= 256, 2 <= dc <= 32, 1 <= nm <= q (nm >= 3 with
    presort, which reads each edge's 3rd best), 1 <= C <= 65536 configs,
    and one warp's shared memory within the block limit (232,448 bytes:
    about 56,000 configs at dc = 4, q = 256, nm = 32 with at most 512 of
    them masked on a position)."""
    if q < 2 or q > MAX_Q or q & (q - 1):
        raise ValueError(f"{name}: q={q} must be a power of two <= {MAX_Q}")
    if not 2 <= dc <= MAX_DC:
        raise ValueError(f"{name}: dc={dc} must lie in [2, {MAX_DC}]")
    if not (3 if presort else 1) <= nm <= q:
        raise ValueError(f"{name}: nm={nm} must lie in "
                         f"[{3 if presort else 1}, q={q}]"
                         + (" with presort" if presort else ""))
    if not 1 <= c <= MAX_CONFIGS:
        raise ValueError(f"{name}: C={c} configs, the kernel holds at most "
                         f"{MAX_CONFIGS}")
    need = smem_bytes(dc, q, nm, c, max_masked)
    if need > _build.SMEM_LIMIT:
        raise ValueError(f"{name}: dc={dc}, q={q}, nm={nm}, C={c} configs "
                         f"need {need} B of shared memory per row, over the "
                         f"{_build.SMEM_LIMIT} B a block may use")


def _check_cn(name, device, dc, q, table, kth, nm, presort, lists):
    """Check the CN's tables for rows of width (dc, q) on ``device``;
    return their ``PositionLists`` (built when ``lists`` is None)."""
    if table.dim() != 2 or table.shape[1] != dc or table.dtype != torch.uint8:
        raise ValueError(f"{name}: table must be uint8 [C, {dc}], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if tuple(kth.shape) != (dc,) or kth.dtype != torch.int32:
        raise ValueError(f"{name}: kth must be int32 [{dc}], got "
                         f"{kth.dtype} {tuple(kth.shape)}")
    for key, tab in (("table", table), ("kth", kth)):
        if tab.device != device or not tab.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on {device}")
    c = table.shape[0]
    if lists is None:
        lists = position_lists(table, kth, nm, device)
    if (lists.nm, lists.n_configs, len(lists.counts)) != (nm, c, dc):
        raise ValueError(f"{name}: position lists for nm={lists.nm}, "
                         f"C={lists.n_configs}, dc={len(lists.counts)}, "
                         f"the rows have nm={nm}, C={c}, dc={dc}")
    for key, tab in (("offsets", lists.offsets), ("configs", lists.configs)):
        if tab.device != device:
            raise ValueError(f"{name}: the position lists' {key} are on "
                             f"{tab.device}, not {device}")
    check_fits(dc, q, nm, c, presort, name, max(lists.counts))
    return lists


def _check(x, table, kth, nm, presort, lists):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"syndrome_rows: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"syndrome_rows: rows must be float32, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"syndrome_rows: rows must be contiguous [T, dc, "
                         f"q], got {tuple(x.shape)}")
    t, dc, q = x.shape
    if t >= 2 ** 31:
        raise ValueError(f"syndrome_rows: T={t} rows, at most 2^31 - 1")
    return _check_cn("syndrome_rows", x.device, dc, q, table, kth, nm,
                     presort, lists)


def _table_args(rot_in, rot_out, valid, table, kth, lists, bayes, presort,
                offset, g):
    """The launchers' shared arguments after the rows' own."""
    return (rot_in.data_ptr(), rot_out.data_ptr(),
            None if valid is None else valid.data_ptr(), g,
            table.data_ptr(), table.shape[0], kth.data_ptr(),
            lists.offsets.data_ptr(), lists.configs.data_ptr(),
            max(lists.counts), int(bayes), int(presort), float(offset),
            torch.cuda.current_stream().cuda_stream)


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
                  offset: float, bayes: bool, presort: bool,
                  lists: PositionLists | None = None) -> torch.Tensor:
    """The syndrome-EMS check-node step of a batch of rows, in one kernel
    launch.

    x: [T, dc, q] float32 unrotated, min-normalised VN-to-CN rows; row t
    uses row ``t % G`` of the per-position tables ``rot_in`` / ``rot_out``
    ([G, dc, q] uint8 gather tables, ``graph.rotation_table``) and of
    ``valid`` ([G, dc] bool, False at padding slots; None: no padding).
    ``table`` [C, dc] uint8 and ``kth`` [dc] int32 are the CN's static
    tables (``syndrome_cn.syndrome_tables``), shared by all rows, and
    ``lists`` their ``position_lists`` (None: built here, reading the table
    on the host); ``nm`` the list length, ``bayes`` and ``presort`` its
    switches.  Returns [T, dc, q] min-normalised outputs, equal bit for bit
    to ``syndrome_rows_plain``.
    """
    global launches
    lists = _check(x, table, kth, nm, presort, lists)
    g = _table_rows(x, rot_in, rot_out, valid, "syndrome_rows")
    if x.device.type == "cpu":
        return syndrome_rows_plain(x, rot_in, rot_out, valid, table, kth, nm,
                                   offset, bayes, presort)
    t, dc, q = x.shape
    out = torch.empty_like(x)
    if t == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib().syndrome_rows_launch(
            x.data_ptr(), out.data_ptr(), t, dc, q, nm,
            *_table_args(rot_in, rot_out, valid, table, kth, lists, bayes,
                         presort, offset, g))
    if err != 0:
        raise RuntimeError(f"syndrome_rows: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out


def _check_layer(app, ctov, active, cols, edges, rot_in, rot_out, valid,
                 table, kth, nm, presort, lists):
    name = "syndrome_layer"
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
    if (edges.dtype != torch.int32 or tuple(edges.shape) != (g, dc)):
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
    return _check_cn(name, app.device, dc, q, table, kth, nm, presort, lists)


def syndrome_layer_plain(app, ctov, active, cols, edges, rot_in, rot_out,
                         valid, table, kth, nm: int, offset: float,
                         bayes: bool, presort: bool) -> None:
    """The plain torch super-layer step that ``syndrome_layer`` fuses, in
    place: gathers (widened to f32), VN extrinsic minus its min,
    ``syndrome_rows_plain``, and the write-back of the real slots of
    active frames, rounded to the state's dtype (a frozen frame or padded
    slot writes back what it read)."""
    cols, edges = cols.long(), edges.long()
    app_rows = app[:, cols].float()                   # [F, G, dc, q]
    ctov_rows = ctov[:, edges].float()
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    f, g, dc, q = mvc.shape
    mcv = syndrome_rows_plain(mvc.reshape(f * g, dc, q), rot_in, rot_out,
                              valid, table, kth, nm, offset, bayes, presort
                              ).reshape(mvc.shape)
    write = active[:, None, None, None]
    if valid is not None:
        write = write & valid[None, :, :, None]
    ctov[:, edges] = torch.where(write, mcv, ctov_rows).to(ctov.dtype)
    app[:, cols] = torch.where(write, mvc + mcv, app_rows).to(app.dtype)


def syndrome_layer(app: torch.Tensor, ctov: torch.Tensor,
                   active: torch.Tensor, cols: torch.Tensor,
                   edges: torch.Tensor, rot_in: torch.Tensor,
                   rot_out: torch.Tensor, valid, table: torch.Tensor,
                   kth: torch.Tensor, nm: int, offset: float, bayes: bool,
                   presort: bool,
                   lists: PositionLists | None = None) -> None:
    """One layered syndrome super-layer, in place, in one kernel launch.

    app: [F, N+1, q] and ctov: [F, E+1, q] contiguous state of one dtype,
    float32 or bfloat16 (a bf16 state is widened to f32 where read and
    rounded to nearest even where written); active: [F] bool (False:
    converged, left untouched); cols, edges: the
    layer's [G, dc] int32 APP columns and CtoV edges (padding slots at
    column N and edge E; the layer's other columns and edges are distinct;
    on the card an index out of range is a device-side fault, as in
    torch's own index kernels); rot_in, rot_out: its [G, dc, q] uint8
    rotation tables; valid: [G, dc] bool (False at padding slots) or None;
    table, kth, lists, nm, offset, bayes, presort: as ``syndrome_rows``.
    For each active frame and row: mvc = APP[cols] - CtoV[edges] minus its
    min, mcv = ``syndrome_rows`` of mvc, then, on the real slots,
    CtoV[edges] = mcv and APP[cols] = mvc + mcv.  Padded slots write
    nothing, so the padding column and edge keep their values.
    """
    global launches, layer_launches
    lists = _check_layer(app, ctov, active, cols, edges, rot_in, rot_out,
                         valid, table, kth, nm, presort, lists)
    if app.device.type == "cpu":
        syndrome_layer_plain(app, ctov, active, cols, edges, rot_in, rot_out,
                             valid, table, kth, nm, offset, bayes, presort)
        return
    f, app_rows, q = app.shape
    g, dc = cols.shape
    if f == 0:
        return
    with torch.cuda.device(app.device):
        err = getattr(_lib(), _LAYER_ENTRY[app.dtype])(
            app.data_ptr(), ctov.data_ptr(), f, app_rows, ctov.shape[1],
            active.data_ptr(), cols.data_ptr(), edges.data_ptr(), dc, q, nm,
            *_table_args(rot_in, rot_out, valid, table, kth, lists, bayes,
                         presort, offset, g))
    if err != 0:
        raise RuntimeError(f"syndrome_layer: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    layer_launches += 1
