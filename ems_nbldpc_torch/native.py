"""ctypes binding of the C++ core ``csrc/nbldpc_core.cpp`` (an oracle).

The core is the C reference's layered bubble-check EMS decoder in f64 with
OpenMP over frames: ``nbldpc_decode_batch`` (sort-truncate to nm, the
8-bubble elementary step with its nbOper budget, offset-saturated dense
CtoV, no min-normalisation of CtoV) and ``nbldpc_elementary_step``.  It is
never on the decode path: tests and ``chip_smoke.py`` hold the port's
golden model and bubble decoders against it.

The port's own binding (``ems_nbldpc_tpu/native.py`` imports the JAX
package): at first use the source is compiled with ``g++`` into
``ems_nbldpc_torch/build/`` under a name that carries a digest of the
source and the flags, so an edited source is rebuilt and nothing is
written into ``csrc/``.  Unlike the JAX binding it raises when ``g++`` or
the source is missing, rather than reporting the library unavailable.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np

from .models.code import NBCode
from .ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "nbldpc_core.cpp")
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared"]


def build() -> tuple[str, float]:
    """Compile the core if it is not built yet; returns (library path,
    seconds spent compiling)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the C++ core cannot be built")
    if not os.path.exists(SOURCE):
        raise RuntimeError(f"the C++ core's source {SOURCE} is missing")
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"libnbldpc_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on nbldpc_core.cpp "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    i32, f64 = ctypes.c_int, ctypes.c_double
    ip = ctypes.POINTER(ctypes.c_int)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.nbldpc_decode_batch.restype = i32
    lib.nbldpc_decode_batch.argtypes = [
        i32, i32, i32, i32, ip, ip, ip, i32, dp, i32, i32, f64, i32, ip, ip,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.nbldpc_elementary_step.restype = i32
    lib.nbldpc_elementary_step.argtypes = [i32, i32, i32, dp, ip, dp, ip, dp,
                                           ip]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_batch(code: NBCode, intrinsic: np.ndarray, max_iters: int,
                 nm: int, offset: float, nb_oper: int):
    """The core's layered 8-bubble decode of every frame.

    intrinsic: [F, N, q] min-cost costs (read as float64).  Returns
    (decide [F, N] int32, iters [F] int32, converged [F] bool)."""
    intrinsic = np.ascontiguousarray(intrinsic, dtype=np.float64)
    f = intrinsic.shape[0]
    if intrinsic.shape[1:] != (code.n, code.q):
        raise ValueError(f"intrinsic {intrinsic.shape} is not [F, "
                         f"{code.n}, {code.q}]")
    tabs = [np.ascontiguousarray(a, dtype=np.int32)
            for a in (code.row_deg, code.row_cols, code.row_coefs)]
    decide = np.zeros((f, code.n), dtype=np.int32)
    iters = np.zeros(f, dtype=np.int32)
    conv = np.zeros(f, dtype=np.uint8)
    rc = _lib().nbldpc_decode_batch(
        code.q, code.n, code.m_rows, code.dc_max,
        *(_ptr(a, ctypes.c_int) for a in tabs), f,
        _ptr(intrinsic, ctypes.c_double), max_iters, nm, offset, nb_oper,
        _ptr(decide, ctypes.c_int), _ptr(iters, ctypes.c_int),
        _ptr(conv, ctypes.c_uint8))
    if rc != 0:
        raise RuntimeError(f"nbldpc_decode_batch failed (rc={rc}): q={code.q}"
                           f" or nm={nm} out of range")
    return decide, iters, conv.astype(bool)


def elementary_step(q: int, v1, g1, v2, g2, nm: int, nb_oper: int):
    """The core's 8-bubble elementary step on one pair of [nm] lists
    (values ascending, GF ids, -1 = unfilled).  Returns (values [nm]
    float64, ids [nm] int32)."""
    v1, v2 = (np.ascontiguousarray(v, np.float64) for v in (v1, v2))
    g1, g2 = (np.ascontiguousarray(g, np.int32) for g in (g1, g2))
    if not all(len(a) == nm for a in (v1, v2, g1, g2)):
        raise ValueError(f"the lists must have nm={nm} entries")
    ov = np.zeros(nm, np.float64)
    og = np.zeros(nm, np.int32)
    rc = _lib().nbldpc_elementary_step(
        q, nm, nb_oper, _ptr(v1, ctypes.c_double), _ptr(g1, ctypes.c_int),
        _ptr(v2, ctypes.c_double), _ptr(g2, ctypes.c_int),
        _ptr(ov, ctypes.c_double), _ptr(og, ctypes.c_int))
    if rc != 0:
        raise RuntimeError(f"nbldpc_elementary_step failed (rc={rc}): "
                           f"q={q} out of range")
    return ov, og
