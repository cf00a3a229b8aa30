"""The layered truncated-list EMS super-layer step as a hand-written CUDA
kernel (K3).

The kernel of ``csrc/list_checknode.cu`` replaces the XLA ops of
``ems_nbldpc_tpu/ops/listcn.py`` on the list path (``topk_list``,
``rotate_ids``, the budgeted staircase branch of ``list_combine``,
``fb_checknode_list``, ``saturate_list``, ``expand_list``) and the
gathers, VN extrinsic, freeze and scatters of the sweep body around them
(``ems_nbldpc_tpu/decoder/layered.py:567-611``).  One entry point launches
it:

* ``list_layer(app, cv_v, cv_g, cv_sat, active, cols, edges, rc_in,
  rc_out, valid, nm, nboper, offset)``: one super-layer of the layered list
  sweep, in place on the decoder state, dense APP and compressed CtoV;
  ``ops/listcn.list_layer_plain`` is its plain torch version.  The state is
  float32 or bfloat16 (``cuda_spa.STATE_DTYPES``): a bf16 state is widened
  to f32 where it is read, and the kernel rounds to nearest even where the
  plain version's bf16 tensors round, so the two agree bit for bit at
  either dtype.

Its limits (``takes``): q a power of two <= 256, 1 <= nm <= min(q, 64),
nboper >= 1, dc >= 1, and one row's shared memory within a block's.  The
exact f32 mode ``nboper = 0`` (three stable f32 sorts over all na * nb
candidates, whose tail ids come from the sort order) is not K3's and is
not ported to the card: the layered decoder runs ``list_layer_plain`` for
it, and for any shape outside the limits, on CPU tensors only, and raises
``ValueError`` for them on the card (``layered._list_layer_step``).

On a CUDA tensor ``list_layer`` launches the kernel or raises; there is no
fallback.  On a CPU tensor it runs the plain version.  The kernel is
compiled with ``nvcc`` for ``sm_90a`` into ``ems_nbldpc_torch/build/`` at
first use and loaded with ``ctypes`` (``ops/_build.py``).  ``launches``
counts the wrapper's eager kernel launches (never plain calls;
``decoder/device_loop`` restores the count after its capture);
``device_launches()`` reads the count the kernel keeps itself on the card,
a CUDA graph's replays included.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .cuda_spa import STATE_DTYPES
from .listcn import list_layer_plain

launches = 0  # eager kernel launches since import (set to 0 to count a run)

WARPS = 4                  # warps per block
MAX_NM = 64                # list entries: two a lane
TAB = 256                  # GF ids a key holds (8 bits)
# the C function by state dtype
_ENTRY = {torch.float32: "list_layer_launch",
          torch.bfloat16: "list_layer_bf16_launch"}


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("list_checknode", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(build()[0])


def _bind(path: str) -> ctypes.CDLL:
    """Load the kernel library at ``path`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr, ptr,
                       ptr, ptr, i64, i32, i32, i32, i32, ctypes.c_float, ptr]
        fn.restype = i32
    lib.list_block_warps.argtypes = [i32, i32, i32, i32]
    lib.list_block_warps.restype = i32
    lib.list_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.list_launches.restype = i32
    lib.list_reset_launches.argtypes = []
    lib.list_reset_launches.restype = i32
    return lib


def device_launches() -> int:
    """The kernel's launches on the current card since its library was
    loaded or ``reset_device_launches()``, counted by the kernel itself
    (one thread of its first block adds one), so the launches a CUDA graph
    replays count too.  Synchronises the card."""
    n = ctypes.c_ulonglong()
    err = _lib().list_launches(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"list_layer: reading the launch count failed "
                           f"with CUDA error {err}")
    return n.value


def reset_device_launches() -> None:
    """Set ``device_launches()`` to 0.  Synchronises the card."""
    err = _lib().list_reset_launches()
    if err != 0:
        raise RuntimeError(f"list_layer: resetting the launch count failed "
                           f"with CUDA error {err}")


def _a16(b: int) -> int:
    return (b + 15) // 16 * 16


def staircase_pairs(nm: int, nboper: int) -> int:
    """Candidates of one merge, {(i+1)(j+1) <= nboper} with i, j < nm
    (``list_combine``'s staircase; 216 at nm = 32, nboper = 64)."""
    w = min(nboper, nm * nm)
    return sum(min(nm, w // (i + 1)) for i in range(nm))


def warp_bytes(dc: int, q: int, nm: int) -> int:
    """Shared memory of one warp on an f32 state (mirrors ``layout`` in
    the .cu source; a bf16 state's mvc takes half): mvc [dc, q], the
    lists (one u32 an entry: a value's bf16 bits over its GF id), dc of
    them for dc <= 2 and 3 dc - 4 otherwise, and one 256-entry u32 table,
    cleared before each use."""
    lists = dc if dc <= 2 else 3 * dc - 4
    return _a16(4 * dc * q) + _a16(4 * lists * nm) + 4 * TAB


def warps_per_block(dc: int, q: int, nm: int, nboper: int) -> int:
    """Warps a block holds on an f32 state (a bf16 state's block holds as
    many): WARPS, fewer where their shared memory and the staircase's pair
    table do not fit one block; 0 if not even one warp fits.  Where
    ``takes``, it equals the library's ``list_block_warps``
    (``block_warps`` in the .cu source, 0 outside its limits), which
    ``chip_smoke.py`` 3f holds it against on the card."""
    room = _build.SMEM_LIMIT - _a16(2 * staircase_pairs(nm, nboper))
    return max(0, min(WARPS, room // warp_bytes(dc, q, nm)))


def limits_error(dc: int, q: int, nm: int, nboper: int) -> str | None:
    """Why K3 does not take this list CN, or None where it does."""
    if q < 2 or q > TAB or q & (q - 1):
        return f"q={q} must be a power of two <= {TAB}"
    if not 1 <= nm <= min(q, MAX_NM):
        return f"nm={nm} must lie in [1, min(q, {MAX_NM})]"
    if nboper < 1:
        return (f"nboper={nboper}: K3 runs the staircase merges "
                "(nboper >= 1); the exact nboper = 0 mode runs on CPU "
                "tensors only (list_layer_plain)")
    if dc < 1:
        return f"dc={dc} must be >= 1"
    if warps_per_block(dc, q, nm, nboper) < 1:
        return (f"dc={dc}, q={q}, nm={nm} needs {warp_bytes(dc, q, nm)} B "
                f"of shared memory a row, over what a block may use")
    return None


def takes(dc: int, q: int, nm: int, nboper: int) -> bool:
    """Whether K3 takes this list CN (``limits_error`` is None)."""
    return limits_error(dc, q, nm, nboper) is None


def _check(app, cv_v, cv_g, cv_sat, active, cols, edges, rc_in, rc_out,
           valid, nm, nboper) -> None:
    """Raise ``ValueError`` (``TypeError`` for a dtype) for a layer the
    kernel does not take."""
    name = "list_layer"
    if app.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {app.device}")
    for key, x in (("app", app), ("cv_v", cv_v), ("cv_sat", cv_sat)):
        if x.dtype not in STATE_DTYPES:
            raise TypeError(f"{name}: {key} must be float32 or bfloat16, "
                            f"got {x.dtype}")
        if x.dtype != app.dtype:
            raise TypeError(f"{name}: {key} is {x.dtype}, app {app.dtype}: "
                            "the state has one dtype")
    if cv_g.dtype != torch.uint8:
        raise TypeError(f"{name}: cv_g must be uint8, got {cv_g.dtype}")
    if app.dim() != 3:
        raise ValueError(f"{name}: app must be [F, N+1, q], got "
                         f"{tuple(app.shape)}")
    f, _, q = app.shape
    if cv_v.dim() != 3 or cv_v.shape[0] != f or cv_v.shape[2] != nm:
        raise ValueError(f"{name}: cv_v must be [{f}, E+1, {nm}], got "
                         f"{tuple(cv_v.shape)}")
    e1 = cv_v.shape[1]
    if tuple(cv_g.shape) != (f, e1, nm) or tuple(cv_sat.shape) != (f, e1):
        raise ValueError(f"{name}: cv_g {tuple(cv_g.shape)} and cv_sat "
                         f"{tuple(cv_sat.shape)} do not match cv_v "
                         f"{tuple(cv_v.shape)}")
    if (active.dtype != torch.bool or tuple(active.shape) != (f,)):
        raise ValueError(f"{name}: active must be [{f}] bool, got "
                         f"{tuple(active.shape)} {active.dtype}")
    if cols.dim() != 2 or cols.dtype != torch.int32:
        raise ValueError(f"{name}: cols must be [G, dc] int32, got "
                         f"{tuple(cols.shape)} {cols.dtype}")
    g, dc = cols.shape
    if g == 0:
        raise ValueError(f"{name}: the tables have no rows")
    if edges.dtype != torch.int32 or tuple(edges.shape) != (g, dc):
        raise ValueError(f"{name}: edges must be [{g}, {dc}] int32, got "
                         f"{tuple(edges.shape)} {edges.dtype}")
    err = limits_error(dc, q, nm, nboper)
    if err is not None:
        raise ValueError(f"{name}: {err}")
    logq = q.bit_length() - 1
    for key, tab, want, dtype in (
            ("rc_in", rc_in, (g, dc, logq), torch.int32),
            ("rc_out", rc_out, (g, dc, logq), torch.int32),
            ("valid", valid, (g, dc), torch.bool)):
        if tab is None and key == "valid":
            continue
        if tab is None or tuple(tab.shape) != want or tab.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {dtype} {want}, got "
                             + ("None" if tab is None else
                                f"{tab.dtype} {tuple(tab.shape)}"))
    for key, x in (("app", app), ("cv_v", cv_v), ("cv_g", cv_g),
                   ("cv_sat", cv_sat), ("active", active), ("cols", cols),
                   ("edges", edges), ("rc_in", rc_in), ("rc_out", rc_out),
                   ("valid", valid)):
        if x is None:
            continue
        if x.device != app.device:
            raise ValueError(f"{name}: {key} is on {x.device}, app on "
                             f"{app.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def list_layer(app: torch.Tensor, cv_v: torch.Tensor, cv_g: torch.Tensor,
               cv_sat: torch.Tensor, active: torch.Tensor,
               cols: torch.Tensor, edges: torch.Tensor, rc_in: torch.Tensor,
               rc_out: torch.Tensor, valid, nm: int, nboper: int,
               offset: float) -> None:
    """One layered truncated-list EMS super-layer, in place, in one kernel
    launch.

    app: [F, N+1, q], cv_v: [F, E+1, nm] and cv_sat: [F, E+1], contiguous,
    of one dtype, float32 or bfloat16; cv_g: [F, E+1, nm] uint8; active:
    [F] bool (False: converged, left untouched); cols, edges: the layer's
    [G, dc] int32 APP columns and CtoV edges (padding slots at column N and
    edge E; the layer's other columns and edges are distinct; on the card
    an index out of range traps); rc_in, rc_out: [G, dc, log2 q] int32
    GF(2)-basis columns of each slot's h and h^-1 (``listcn.mul_cols``);
    valid: [G, dc] bool (False at padded slots) or None; nm, nboper,
    offset: the list length, the merges' candidate budget (>= 1: the
    staircase) and the saturation offset.  Equal bit for bit to
    ``listcn.list_layer_plain`` on every real slot, frozen frame and row
    the layer does not own; padded slots write nothing, so the padding
    column and edge keep their values (the plain version scatters its
    padded slots there).  Outside ``takes``' limits it raises
    ``ValueError`` on either device.
    """
    global launches
    _check(app, cv_v, cv_g, cv_sat, active, cols, edges, rc_in, rc_out,
           valid, nm, nboper)
    if app.device.type == "cpu":
        list_layer_plain(app, cv_v, cv_g, cv_sat, active, cols, edges, rc_in,
                         rc_out, valid, nm, nboper, offset)
        return
    f = app.shape[0]
    if f == 0:
        return
    g, dc = cols.shape
    with torch.cuda.device(app.device):
        err = getattr(_lib(), _ENTRY[app.dtype])(
            app.data_ptr(), cv_v.data_ptr(), cv_g.data_ptr(),
            cv_sat.data_ptr(), f, app.shape[1], cv_v.shape[1],
            active.data_ptr(), cols.data_ptr(), edges.data_ptr(),
            rc_in.data_ptr(), rc_out.data_ptr(),
            None if valid is None else valid.data_ptr(), g, dc,
            app.shape[2], nm, nboper, float(offset),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"list_layer: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
