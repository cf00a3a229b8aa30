"""Named access to parity-check matrices.

Copy of ``ems_nbldpc_tpu/models/registry.py`` over the port's own
``models/code.load``.  The matrix files are external data: they are read
from the directory named by ``NBLDPC_MATRIX_DIR``, else from ``matrices/``
at the repository root, rather than bundled.  Codes resolve lazily and are
cached.
"""
from __future__ import annotations

import functools
import os

from .code import NBCode, load

DEFAULT_DIRS = (
    os.environ.get("NBLDPC_MATRIX_DIR", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "matrices"),
)


def matrix_path(name: str) -> str:
    """Resolve a matrix name ('Mat24_N48_M24', 'KN/N576_K480_GF64.txt', ...)
    or a path."""
    if os.path.exists(name):   # absolute or cwd-relative path
        return name
    for d in DEFAULT_DIRS:
        if not d:
            continue
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
        if os.path.exists(p + ".txt"):
            return p + ".txt"
    raise FileNotFoundError(f"matrix {name!r} not found in {DEFAULT_DIRS}")


@functools.lru_cache(maxsize=None)
def get_code(name: str, fmt: str = "auto") -> NBCode:
    return load(matrix_path(name), fmt=fmt, name=name)


def available(subdir: str = "") -> list:
    out = []
    for d in DEFAULT_DIRS:
        base = os.path.join(d, subdir) if subdir else d
        if d and os.path.isdir(base):
            for f in sorted(os.listdir(base)):
                p = os.path.join(base, f)
                if os.path.isfile(p) and not f.endswith(".gz"):
                    out.append(os.path.join(subdir, f) if subdir else f)
            break
    return out
