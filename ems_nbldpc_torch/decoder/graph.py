"""Static index arrays for a code graph, and their upload to a device.

Port of ``ems_nbldpc_tpu/decoder/graph.py``, reduced to what the port's
device path reads.  The JAX package chose between grouped static
permutations (``RotationPlan``), a gather and a one-hot matmul, because a
per-row gather is slow on a TPU.  On the GPU a gather along the last axis
is a plain indexed load, so a rotation here is one ``torch.gather`` with a
per-position ``[P, q]`` table (the JAX ``"gather"`` mode).

The tables put on a device are cached (``device_tables``).  A captured
CUDA graph reads them by address, so its owner keeps the ones its step
used (``keep_tables``): the cache may drop them, the owner still holds
them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from ..models.code import NBCode

_CACHES = []                # every device_tables function
_kept = None                # the dict of the innermost keep_tables block


def device_tables(fn):
    """``functools.lru_cache(maxsize=16)`` for a function of (graph,
    device) that returns tables on the device; inside ``keep_tables(kept)``
    every result it hands out is also kept in ``kept``."""
    cached = functools.lru_cache(maxsize=16)(fn)
    _CACHES.append(cached)

    @functools.wraps(fn)
    def tables(*args):
        out = cached(*args)
        if _kept is not None:
            _kept[id(out)] = out
        return out

    tables.cache_clear = cached.cache_clear
    return tables


@contextlib.contextmanager
def keep_tables(kept: dict):
    """Inside the block, the results of every ``device_tables`` call are
    also put in ``kept`` (id -> tables), so that whoever holds ``kept``
    keeps them alive."""
    global _kept
    outer, _kept = _kept, kept
    try:
        yield kept
    finally:
        _kept = outer


def clear_tables() -> None:
    """Empty every ``device_tables`` cache."""
    for cached in _CACHES:
        cached.cache_clear()


def rotation_table(coefs: np.ndarray, gf, direction: str) -> np.ndarray:
    """[P, q] int64 gather table for P positions with GF coefficients
    ``coefs`` (0 = padding: identity).

    ``"in"``:  vr[u] = v[h^-1 u]   -> table[p] = h_p^-1 * (0..q-1)
    ``"out"``: mcv[c] = mcv_r[h c] -> table[p] = h_p * (0..q-1)
    """
    coefs = np.asarray(coefs, np.int64).reshape(-1)
    pad = coefs == 0
    h = np.where(pad, 1, coefs)
    if direction == "in":
        h = gf.inv(h)
    elif direction != "out":
        raise ValueError(f"direction={direction!r}")
    return gf.mul_table[h].astype(np.int64)     # mul_table[1] = identity


def rotate(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x: [F, P, q]; table: [P, q] (from ``rotation_table``) -> [F, P, q]."""
    return torch.gather(x, -1, table.expand(x.shape[0], -1, -1))


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceGraph:
    """A code and the static index arrays the device path reads (NumPy);
    ``upload`` puts them on a device."""

    code: NBCode
    regular: bool               # all rows have degree dc_max
    col_edges: np.ndarray       # [N, dv_max], pad = E
    row_edges: np.ndarray       # [M, dc_max], pad = E
    edge_valid_row: np.ndarray  # [M, dc_max] bool, False at padded slots
    edge_slot: np.ndarray       # [E] position of each edge within its row
    layers: tuple               # tuple of row-id arrays (column-disjoint groups)

    @classmethod
    @functools.lru_cache(maxsize=None)
    def from_code(cls, code: NBCode) -> "DeviceGraph":
        e = code.n_edges
        row_edges = code.row_edges
        offs = np.concatenate([[0], np.cumsum(code.row_deg)])
        slot = np.arange(e) - np.repeat(offs[:-1], code.row_deg)
        return cls(
            code=code,
            regular=bool(np.all(code.row_deg == code.dc_max)),
            col_edges=code.col_edges.astype(np.int32),
            row_edges=row_edges.astype(np.int32),
            edge_valid_row=row_edges < e,
            edge_slot=slot.astype(np.int32),
            layers=code.layers,
        )

    @property
    def q(self) -> int:
        return self.code.q

    @property
    def n_edges(self) -> int:
        return self.code.n_edges


@device_tables
def upload(g: DeviceGraph, device: str) -> dict:
    """The index arrays the device path reads, as int64 tensors on
    ``device`` (uploaded once per graph and device): the edge tables and
    the flat GF multiplication table; ``edge_valid_row`` is bool."""
    def up(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    code = g.code
    return dict(
        edge_col=up(code.edge_col),
        edge_row=up(code.edge_row),
        edge_coef=up(code.edge_coef),
        edge_slot=up(g.edge_slot),
        col_edges=up(g.col_edges),
        row_edges=up(g.row_edges),
        edge_valid_row=torch.as_tensor(g.edge_valid_row, device=device),
        mul_flat=up(code.gf.mul_table.reshape(-1)),
    )
