"""The layered decoders' hard decisions as a hand-written CUDA kernel (K4).

The kernel of ``csrc/decide.cu`` replaces the XLA argmin of
``ems_nbldpc_tpu/decoder/layered.py`` (``:250``, ``:328``, ``:711``: the
argmin over the APP, then the latch of the active frames; no Pallas kernel
there).  One entry point:

* ``decide_rows(app, decide, active=None)``: in place, ``decide[f, v] =
  argmin_a app[f, v, a]`` for every ``v < N`` of every frame with
  ``active[f]`` (every frame when ``active`` is None: a decode's reset);
  the other frames are neither read nor written, so their decisions stay
  latched.  ``decide_rows_plain`` is its plain torch version (the argmin
  and ``torch.where`` it replaces).  Ties go to the lowest index and a NaN
  is the minimum (the first NaN wins), as ``torch.argmin`` has them: the
  kernel equals the plain version bit for bit, on float32 and bfloat16
  APPs (``cuda_spa.STATE_DTYPES``) and every q of ``gf.PRIM_POLY``.

On a CUDA tensor ``decide_rows`` launches the kernel or raises; there is no
fallback.  On a CPU tensor it runs the plain version.  The kernel is
compiled with ``nvcc`` for ``sm_90a`` into ``ems_nbldpc_torch/build/`` at
first use and loaded with ``ctypes`` (``ops/_build.py``).  ``launches``
counts the wrapper's eager kernel launches (never plain calls;
``decoder/device_loop`` restores the count after its capture);
``device_launches()`` reads the count the kernel keeps itself on the card,
a CUDA graph's replays included, and ``device_rows()`` the (frame,
variable) rows it decided: a frozen frame's rows are not among them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .cuda_spa import STATE_DTYPES

launches = 0  # eager kernel launches since import (set to 0 to count a run)

# the C function by APP dtype
_ENTRY = {torch.float32: "decide_launch",
          torch.bfloat16: "decide_bf16_launch"}


def build(verbose: bool = False) -> tuple[str, float, str]:
    """Compile the kernel library if it is not built yet (``_build.build``)."""
    return _build.build("decide", verbose)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, ptr]
        fn.restype = i32
    u64p = ctypes.POINTER(ctypes.c_ulonglong)
    lib.decide_counts.argtypes = [u64p, u64p]
    lib.decide_counts.restype = i32
    lib.decide_reset_counts.argtypes = []
    lib.decide_reset_counts.restype = i32
    return lib


def _counts() -> tuple[int, int]:
    n, rows = ctypes.c_ulonglong(), ctypes.c_ulonglong()
    err = _lib().decide_counts(ctypes.byref(n), ctypes.byref(rows))
    if err != 0:
        raise RuntimeError(f"decide_rows: reading the counts failed with "
                           f"CUDA error {err}")
    return n.value, rows.value


def device_launches() -> int:
    """The kernel's launches on the current card since its library was
    loaded or ``reset_device_launches()``, counted by the kernel itself
    (one thread of its first block adds one), so the launches a CUDA graph
    replays count too.  Synchronises the card."""
    return _counts()[0]


def device_rows() -> int:
    """The (frame, variable) rows the kernel decided on the current card
    since its library was loaded or ``reset_device_launches()``, counted
    by the kernel (one atomic a block): N a launch for each frame it
    decided.  Synchronises the card."""
    return _counts()[1]


def reset_device_launches() -> None:
    """Set ``device_launches()`` and ``device_rows()`` to 0.  Synchronises
    the card."""
    err = _lib().decide_reset_counts()
    if err != 0:
        raise RuntimeError(f"decide_rows: resetting the counts failed with "
                           f"CUDA error {err}")


def _check(app, decide, active) -> None:
    """Raise ``ValueError`` (``TypeError`` for a dtype) for arguments the
    kernel does not take."""
    name = "decide_rows"
    if app.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {app.device}")
    if app.dtype not in STATE_DTYPES:
        raise TypeError(f"{name}: app must be float32 or bfloat16, got "
                        f"{app.dtype}")
    if decide.dtype != torch.int64:
        raise TypeError(f"{name}: decide must be int64, got {decide.dtype}")
    if app.dim() != 3 or decide.dim() != 2:
        raise ValueError(f"{name}: app must be [F, N+1, q] and decide "
                         f"[F, N], got {tuple(app.shape)} and "
                         f"{tuple(decide.shape)}")
    f, n1, q = app.shape
    if decide.shape[0] != f or decide.shape[1] > n1:
        raise ValueError(f"{name}: decide {tuple(decide.shape)} does not "
                         f"fit app {tuple(app.shape)}")
    if q < 4 or q > 256 or q & (q - 1):
        raise ValueError(f"{name}: q={q} must be a power of two in 4..256")
    if active is not None and (active.dtype != torch.bool
                               or tuple(active.shape) != (f,)):
        raise ValueError(f"{name}: active must be [{f}] bool, got "
                         f"{tuple(active.shape)} {active.dtype}")
    for key, x in (("app", app), ("decide", decide), ("active", active)):
        if x is None:
            continue
        if x.device != app.device:
            raise ValueError(f"{name}: {key} is on {x.device}, app on "
                             f"{app.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def decide_rows_plain(app: torch.Tensor, decide: torch.Tensor,
                      active: torch.Tensor | None = None) -> torch.Tensor:
    """``decide_rows`` in torch: the argmin over the APP of every frame,
    then the latch of the active ones (any device)."""
    new = app[:, :decide.shape[1]].argmin(dim=-1)
    if active is not None:
        new = torch.where(active[:, None], new, decide)
    return decide.copy_(new)


def decide_rows(app: torch.Tensor, decide: torch.Tensor,
                active: torch.Tensor | None = None) -> torch.Tensor:
    """In place: ``decide[f, v] = argmin_a app[f, v, a]`` for ``v < N`` of
    every frame ``f`` with ``active[f]`` (every frame when ``active`` is
    None), in one kernel launch on the card; returns ``decide``.

    app: [F, N+1, q] (or any [F, >= N, q]) float32 or bfloat16, q a power of
    two in 4..256; decide: [F, N] int64; active: [F] bool or None; all
    contiguous on one device.  Frames with ``active[f]`` False are neither
    read nor written.  Equal bit for bit to ``decide_rows_plain``."""
    global launches
    _check(app, decide, active)
    if app.device.type == "cpu":
        return decide_rows_plain(app, decide, active)
    f, n = decide.shape
    if f * n == 0:
        return decide
    if app.data_ptr() % min(16, app.shape[2] * app.element_size()):
        raise ValueError("decide_rows: app must be aligned to 16 bytes (8 "
                         "for a bf16 APP at q = 4)")
    with torch.cuda.device(app.device):
        err = getattr(_lib(), _ENTRY[app.dtype])(
            app.data_ptr(), decide.data_ptr(),
            None if active is None else active.data_ptr(), f, app.shape[1],
            n, app.shape[2], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decide_rows: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return decide
