"""A kernel's share of its roofline over a traced stretch.

The traced batches' launches of the kernel come in the order the device
loop ran them: step after step, each step the super-layers in order.  A
launch at step s works on the frames still active there, the frames whose
iteration count exceeds s.  The share is the sum of the launches' bounds
(``simbench.bounds``) over the sum of their traced times.
"""
from __future__ import annotations

import sys


def share(run: dict, names: tuple, bound_ms):
    prof = run.get("profile")
    if not prof:
        return None
    launches = [dur for _, dur, name in prof["kernels"]
                if any(n in name for n in names)]
    if not launches:
        return None
    layers, dc, q = run["shape"]["layers"], run["shape"]["dc"], run["shape"]["q"]
    bounds = []
    for iters in prof["iters"]:
        for s in range(int(iters.max()) if len(iters) else 0):
            f_active = int((iters > s).sum())
            bounds += [bound_ms(f_active, g, dc, q, run["config"])
                       for g in layers]
    if len(bounds) != len(launches):
        print(f"roofline {names}: {len(launches)} launches traced, "
              f"{len(bounds)} expected from the batches' steps; not read",
              file=sys.stderr)
        return None
    return 100.0 * sum(bounds) / (sum(launches) / 1e3)
