"""Means over the split batches that the host queued within the spin."""
from __future__ import annotations


def mean(run: dict, key: str):
    xs = [s[key] for s in run.get("splits", []) if s["queued"]]
    return sum(xs) / len(xs) if xs else None
