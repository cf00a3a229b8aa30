"""The layered truncated-list EMS super-layer step as a hand-written CUDA
kernel (K3).

The kernel of ``csrc/list_checknode.cu`` replaces the XLA ops of
``ems_nbldpc_tpu/ops/listcn.py`` on the list path (``topk_list`` and, in
the exact mode, ``minconv.topk_message``; ``rotate_ids``; both branches of
``list_combine``: the budgeted staircase and the exact top-nm-distinct
merge; ``fb_checknode_list``, ``saturate_list``, ``expand_list``) and the
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

Its limits (``takes``) are the plain version's: q a power of two <= 256,
1 <= nm <= q, dc >= 1, any nboper (<= 0: the exact mode).  The library
picks one of four paths for a shape (``path`` asks it): the fast step
(the staircase, nm <= 64, one row within a block's shared memory: the
bench row's), the exact mode in the fast step's structure (nboper <= 0,
nm <= 64, one row within a block: the CLI's ``--storage compressed``
default), and the general step for every other shape, nm past 64 among
them (the exact merge at q = 256 and nm = q as dense XOR
min-convolutions, at every other nm as pruned list merges; the staircase
on 32-bit selections), with a row's mvc and lists in shared memory where one
warp's fit a block, else in a global workspace, which also holds the
dense form's lists for a row with a tail.  The library sizes the
workspace, and ``list_layer`` allocates it from torch's caching
allocator for each call (a CUDA graph's capture takes it into its pool).

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

PATHS = (None, "fast", "shared", "workspace", "exact")  # list_path's codes
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
                       ptr, ptr, i64, i32, i32, i32, i32, ctypes.c_float, ptr,
                       i64, ptr]
        fn.restype = i32
    lib.list_path.argtypes = [i32, i32, i32, i32]
    lib.list_path.restype = i32
    lib.list_workspace_bytes.argtypes = [i64, i32, i32, i32, i32, i32]
    lib.list_workspace_bytes.restype = i64
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


def staircase_pairs(nm: int, nboper: int) -> int:
    """Candidates of one merge, {(i+1)(j+1) <= nboper} with i, j < nm
    (``list_combine``'s staircase; 216 at nm = 32, nboper = 64)."""
    w = min(nboper, nm * nm)
    return sum(min(nm, w // (i + 1)) for i in range(nm))


def limits_error(dc: int, q: int, nm: int) -> str | None:
    """Why K3 does not take this list CN, or None where it does: only
    inputs that ``list_layer_plain`` refuses too (for every nboper)."""
    if q < 2 or q > 256 or q & (q - 1):
        return f"q={q} must be a power of two <= 256"
    if not 1 <= nm <= q:
        return f"nm={nm} must lie in [1, q={q}]"
    if dc < 1:
        return f"dc={dc} must be >= 1"
    return None


def path(dc: int, q: int, nm: int, nboper: int) -> str | None:
    """Where the library runs this list CN on the card: "fast" (the
    staircase, nm <= 64, one row in a block's shared memory), "exact" (the
    exact mode, nboper <= 0, within the same limits), else the general
    step, "shared" where one warp's rows fit a block, else "workspace";
    None where refused.  Builds and loads the library."""
    return PATHS[_lib().list_path(dc, q, nm, nboper)]


def takes(dc: int, q: int, nm: int) -> bool:
    """Whether K3 takes this list CN (``limits_error`` is None), for every
    nboper."""
    return limits_error(dc, q, nm) is None


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
    err = limits_error(dc, q, nm)
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
    launch (and, on the workspace path, one allocation of its workspace).

    app: [F, N+1, q], cv_v: [F, E+1, nm] and cv_sat: [F, E+1], contiguous,
    of one dtype, float32 or bfloat16; cv_g: [F, E+1, nm] uint8; active:
    [F] bool (False: converged, left untouched); cols, edges: the layer's
    [G, dc] int32 APP columns and CtoV edges (padding slots at column N and
    edge E; the layer's other columns and edges are distinct; on the card
    an index out of range traps); rc_in, rc_out: [G, dc, log2 q] int32
    GF(2)-basis columns of each slot's h and h^-1 (``listcn.mul_cols``);
    valid: [G, dc] bool (False at padded slots) or None; nm, nboper,
    offset: the list length, the merges' candidate budget (>= 1: the
    staircase; <= 0: the exact merge) and the saturation offset.  Equal
    bit for bit to ``listcn.list_layer_plain`` on every real slot, frozen
    frame and row the layer does not own; padded slots write nothing, so
    the padding column and edge keep their values (the plain version
    scatters its padded slots there).  Outside ``takes``' limits it
    raises ``ValueError`` on either device."""
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
    q = app.shape[2]
    lib = _lib()
    with torch.cuda.device(app.device):
        # rows past a block's shared memory, and the dense form's tails,
        # run from a workspace
        nbytes = lib.list_workspace_bytes(f * g, dc, q, nm, nboper,
                                          app.element_size())
        if nbytes < 0:
            raise RuntimeError(f"list_layer: sizing the workspace failed "
                               f"with CUDA error {-nbytes}")
        ws = (torch.empty(nbytes, dtype=torch.uint8, device=app.device)
              if nbytes else None)
        err = getattr(lib, _ENTRY[app.dtype])(
            app.data_ptr(), cv_v.data_ptr(), cv_g.data_ptr(),
            cv_sat.data_ptr(), f, app.shape[1], cv_v.shape[1],
            active.data_ptr(), cols.data_ptr(), edges.data_ptr(),
            rc_in.data_ptr(), rc_out.data_ptr(),
            None if valid is None else valid.data_ptr(), g, dc, q, nm,
            nboper, float(offset), None if ws is None else ws.data_ptr(),
            nbytes, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"list_layer: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
