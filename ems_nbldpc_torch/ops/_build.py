"""Build a CUDA source of ``ems_nbldpc_torch/csrc/`` into a shared library.

Each kernel is one ``.cu`` file with a plain ``extern "C"`` launcher,
compiled by ``nvcc`` for ``sm_90a`` into ``ems_nbldpc_torch/build/`` at
first use and loaded with ``ctypes``.  The library name carries a digest
of the source and the flags, so an edited source is rebuilt; a finished
build is renamed into place, so concurrent builds never see half a file.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# dynamic shared memory one block may use on Hopper
SMEM_LIMIT = 232448


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (put the CUDA toolkit's bin on PATH)")
    return path


def build(name: str, verbose: bool = False,
          source: str | None = None) -> tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` (or ``source``, a variant of it) if it is
    not built yet.

    Returns (library path, seconds spent compiling, compiler output).
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills).
    """
    source = source or os.path.join(CSRC, f"{name}.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    # -Xptxas -v only reports; the library is the same, so is its name
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds, proc.stdout + proc.stderr
