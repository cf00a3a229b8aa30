"""Makers of a configuration's code matrix, one module per ``code.kind``:
``make(**args)`` returns (each row's columns, each row's coefficients in
polynomial representation).  The benchmark makes the matrix itself and
hands the same rows to the program and to the reference."""
from __future__ import annotations

import importlib


def make(spec: dict):
    args = {k: v for k, v in spec.items() if k != "kind"}
    return importlib.import_module(f"{__name__}.{spec['kind']}").make(**args)
