"""The SPA check node as a hand-written CUDA kernel, and the layered SPA
super-layer step around it.

The kernel of ``csrc/spa_checknode.cu`` replaces the XLA op
``ems_nbldpc_tpu/ops/fht.fb_checknode_spa_fused`` (the whole sum-product
check node, with the GF rotations folded into the Walsh-Hadamard
transform) and the torch passes around its layered call site.  Two entry
points launch it:

* ``spa_layer(app, ctov, active, cols, edges, coefs, t_tab, tinv_tab)``:
  one super-layer of the layered sweep, in place on the decoder state
  (gathers, VN extrinsic and its normalisation, check node, freeze of
  converged frames, write-back); ``spa_layer_plain`` is its plain torch
  version.  The layered decoder runs it for ``cn="spa"``.  The state is
  float32 or bfloat16 (``STATE_DTYPES``): a bf16 state is widened to f32
  where it is read, the step computes in f32, and each store rounds once
  to nearest even (torch's ``.to(torch.bfloat16)``, the kernel's
  ``__float2bfloat16_rn``).
* ``spa_checknode(mvc, coefs, t_tab, tinv_tab)``: the check node alone on
  gathered rows; its plain version is ``fht.spa_checknode_plain``.  The
  flooding decoder runs it for ``cn="spa"``.

On a CUDA tensor each wrapper launches the kernel or raises; there is no
fallback.  On a CPU tensor it runs the plain version.  The two agree to
float rounding: the kernel's butterflies and the plain version's matrix
products sum in different orders.  The kernel is compiled with ``nvcc``
for ``sm_90a`` into ``ems_nbldpc_torch/build/`` at first use and loaded
with ``ctypes`` (``ops/_build.py``).  ``launches`` counts the wrappers'
eager kernel launches of both entries, ``layer_launches`` those of
``spa_layer`` (never plain calls; a stream capture records launches
without making them, and ``decoder/device_loop`` restores the counts after
its capture).  ``device_launches()`` reads the counts the kernel keeps
itself on the card: one per launch, a CUDA graph's replays included.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fht import position_tables, spa_checknode_plain

launches = 0  # eager kernel launches since import (set to 0 to count a run)
layer_launches = 0  # the part of ``launches`` made by ``spa_layer``

# the state dtypes the fused entries (K2's, K7's, K9's) take
STATE_DTYPES = (torch.float32, torch.bfloat16)
_LAYER_ENTRY = {torch.float32: "spa_layer_launch",
                torch.bfloat16: "spa_layer_bf16_launch"}


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("spa_checknode", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spa_checknode_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr,
    ]
    lib.spa_checknode_launch.restype = i32
    for name in _LAYER_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i64, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr,
                       i32, i32, i32, ptr]
        fn.restype = i32
    lib.spa_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.spa_launches.restype = i32
    lib.spa_reset_launches.argtypes = []
    lib.spa_reset_launches.restype = i32
    return lib


def device_launches() -> tuple[int, int]:
    """(launches of both entries, the part made by ``spa_layer``) of the
    kernel on the current card since its library was loaded or
    ``reset_device_launches()``, counted by the kernel itself (one thread
    of its first block adds one), so the launches a CUDA graph replays
    count too.  Synchronises the card."""
    n = (ctypes.c_ulonglong * 2)()
    err = _lib().spa_launches(n)
    if err != 0:
        raise RuntimeError(f"spa_checknode: reading the launch counts failed "
                           f"with CUDA error {err}")
    return n[0] + n[1], n[1]


def reset_device_launches() -> None:
    """Set ``device_launches()`` to (0, 0).  Synchronises the card."""
    err = _lib().spa_reset_launches()
    if err != 0:
        raise RuntimeError(f"spa_checknode: resetting the launch counts "
                           f"failed with CUDA error {err}")


def smem_bytes(dc: int, q: int, fused: bool = False) -> int:
    """The least shared memory of a launch: the block's basis images and
    one warp's row buffer and products (mirrors spa_smem_bytes in the
    .cu)."""
    return 16 * q + 4 * ((2 if fused else 1) + 1) * dc * q


def _check_rows(name, dc, q, fused) -> None:
    if q < 2 or q > 256 or q & (q - 1):
        raise ValueError(f"{name}: q={q} must be a power of two <= 256")
    if dc < 2:
        raise ValueError(f"{name}: dc={dc} must be >= 2")
    if smem_bytes(dc, q, fused) > _build.SMEM_LIMIT:
        raise ValueError(f"{name}: dc={dc}, q={q} needs "
                         f"{smem_bytes(dc, q, fused)} B of shared memory")


def _check_tables(name, device, q, dc, t_tab, tinv_tab, **index) -> int:
    """Check the [G, dc] int32 index tables and the two [q, q] uint8
    transform tables; return G."""
    g = None
    for key, x in index.items():
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != dc:
            raise ValueError(f"{name}: {key} must be [G, {dc}] int32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if g is not None and x.shape[0] != g:
            raise ValueError(f"{name}: {key} has {x.shape[0]} rows, "
                             f"expected {g}")
        g = x.shape[0]
    for key, tab in (("t_tab", t_tab), ("tinv_tab", tinv_tab)):
        if tab.dtype != torch.uint8 or tuple(tab.shape) != (q, q):
            raise ValueError(f"{name}: {key} must be [{q}, {q}] uint8, got "
                             f"{tuple(tab.shape)} {tab.dtype}")
    for key, x in (*index.items(), ("t_tab", t_tab), ("tinv_tab", tinv_tab)):
        if x.device != device:
            raise ValueError(f"{name}: {key} is on {x.device}, the rows on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if g == 0:
        raise ValueError(f"{name}: the tables have no rows")
    return g


def _check(mvc, coefs, t_tab, tinv_tab) -> None:
    if mvc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spa_checknode: unsupported device {mvc.device}")
    if mvc.dtype != torch.float32:
        raise TypeError(f"spa_checknode: mvc must be float32, got {mvc.dtype}")
    if mvc.dim() != 3:
        raise ValueError(f"spa_checknode: mvc must be [T, dc, q], got "
                         f"{tuple(mvc.shape)}")
    if not mvc.is_contiguous():
        raise ValueError("spa_checknode: mvc must be contiguous")
    t, dc, q = mvc.shape
    _check_rows("spa_checknode", dc, q, False)
    g = _check_tables("spa_checknode", mvc.device, q, dc, t_tab, tinv_tab,
                      coefs=coefs)
    if t % g:
        raise ValueError(f"spa_checknode: T={t} is not a multiple of G={g}")
    if t >= 2 ** 30:
        raise ValueError(f"spa_checknode: T={t} rows is too many")


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


def check_state(name, app, ctov) -> None:
    """A fused entry's state: APP and CtoV of one dtype of
    ``STATE_DTYPES``, else ``TypeError``."""
    for key, x in (("app", app), ("ctov", ctov)):
        if x.dtype not in STATE_DTYPES:
            raise TypeError(f"{name}: {key} must be float32 or bfloat16, "
                            f"got {x.dtype}")
    if app.dtype != ctov.dtype:
        raise TypeError(f"{name}: app is {app.dtype}, ctov {ctov.dtype}: "
                        "the state has one dtype")


def _check_layer(app, ctov, active, cols, edges, coefs, t_tab,
                 tinv_tab) -> None:
    name = "spa_layer"
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
        # the kernel stages a bf16 state in 4-byte copies at least
        if x.device.type == "cuda" and x.data_ptr() % 4:
            raise ValueError(f"{name}: {key} must be 4-byte aligned")
    f, _, q = app.shape
    if ctov.shape[0] != f or ctov.shape[2] != q:
        raise ValueError(f"{name}: ctov {tuple(ctov.shape)} does not match "
                         f"app {tuple(app.shape)}")
    if (active.dtype != torch.bool or tuple(active.shape) != (f,)
            or active.device != app.device or not active.is_contiguous()):
        raise ValueError(f"{name}: active must be [{f}] bool on "
                         f"{app.device}, got {tuple(active.shape)} "
                         f"{active.dtype} on {active.device}")
    if cols.dim() != 2:
        raise ValueError(f"{name}: cols must be [G, dc], got "
                         f"{tuple(cols.shape)}")
    dc = cols.shape[1]
    _check_rows(name, dc, q, True)
    g = _check_tables(name, app.device, q, dc, t_tab, tinv_tab, cols=cols,
                      edges=edges, coefs=coefs)
    if f * g >= 2 ** 30:
        raise ValueError(f"{name}: F*G = {f * g} rows is too many")


def spa_layer_plain(app, ctov, active, cols, edges, coefs, t_tab,
                    tinv_tab) -> None:
    """The plain torch super-layer step that ``spa_layer`` fuses, in
    place: gathers (widened to f32), VN extrinsic minus its min,
    ``spa_checknode_plain``, and the write-back of active frames (rounded
    to the state's dtype)."""
    cols, edges = cols.long(), edges.long()
    app_rows = app[:, cols].float()                   # [F, G, dc, q]
    ctov_rows = ctov[:, edges].float()
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    t_in, t_out = position_tables(coefs, t_tab, tinv_tab)
    mcv = spa_checknode_plain(mvc, t_in, t_out)       # min 0 already
    act = active[:, None, None, None]
    # freeze converged frames (their APP/CtoV stop changing)
    ctov[:, edges] = torch.where(act, mcv, ctov_rows).to(ctov.dtype)
    app[:, cols] = torch.where(act, mvc + mcv, app_rows).to(app.dtype)


def spa_layer(app: torch.Tensor, ctov: torch.Tensor, active: torch.Tensor,
              cols: torch.Tensor, edges: torch.Tensor, coefs: torch.Tensor,
              t_tab: torch.Tensor, tinv_tab: torch.Tensor) -> None:
    """One layered SPA super-layer, in place, in one kernel launch.

    app: [F, N+1, q] and ctov: [F, E+1, q] contiguous state of one dtype,
    float32 or bfloat16 (widened where read, rounded where written), with
    the padding column N and edge E at 0; active: [F] bool (False:
    converged, left untouched); cols, edges, coefs: the layer's [G, dc]
    int32 APP columns, CtoV edges and GF coefficients (0 = padding slot,
    at column N and edge E; the layer's other columns and edges are
    distinct; on the card an index out of range is a device-side fault, as
    in torch's own index kernels); t_tab, tinv_tab: the
    [q, q] uint8 ``fht.transpose_perm_tables``.  For each active frame and
    row: mvc = APP[cols] - CtoV[edges] minus its min, mcv = the SPA check
    node of mvc, then CtoV[edges] = mcv and APP[cols] = mvc + mcv.
    """
    global launches, layer_launches
    _check_layer(app, ctov, active, cols, edges, coefs, t_tab, tinv_tab)
    if app.device.type == "cpu":
        spa_layer_plain(app, ctov, active, cols, edges, coefs, t_tab,
                        tinv_tab)
        return
    f, app_rows, q = app.shape
    g, dc = cols.shape
    if f == 0:
        return
    with torch.cuda.device(app.device):
        err = getattr(_lib(), _LAYER_ENTRY[app.dtype])(
            app.data_ptr(), ctov.data_ptr(), f, app_rows, ctov.shape[1],
            active.data_ptr(), cols.data_ptr(), edges.data_ptr(),
            coefs.data_ptr(), t_tab.data_ptr(), tinv_tab.data_ptr(), g, dc,
            q, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"spa_layer: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    layer_launches += 1
