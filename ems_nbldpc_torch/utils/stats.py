"""Binomial confidence intervals for FER estimates (copy of the JAX
package's ``utils/stats.py``)."""
from __future__ import annotations

import math


def wilson_ci(k: int, n: int, z: float = 1.96):
    """Wilson score interval for k successes in n trials."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    z2 = z * z
    denom = 1 + z2 / n
    center = (p + z2 / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z2 / (4 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def overlapping(k1, n1, k2, n2, z: float = 1.96) -> bool:
    """Do the two FER estimates' CIs overlap?"""
    lo1, hi1 = wilson_ci(k1, n1, z)
    lo2, hi2 = wilson_ci(k2, n2, z)
    return not (hi1 < lo2 or hi2 < lo1)
