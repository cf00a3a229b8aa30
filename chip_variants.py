#!/usr/bin/env python3
"""Time design variants of the SPA kernel against its committed source, on
one CUDA card.

    python3 chip_variants.py             # every variant, from the repo root
    python3 chip_variants.py NAME ...    # some of them

A variant is ``ems_nbldpc_torch/csrc/spa_checknode.cu`` with a few text
substitutions, written to a temporary directory, built by ``ops/_build.py``
(into ``ems_nbldpc_torch/build/``, named by its digest) and loaded in place
of the committed library.  All variants are timed in one process, in
turns, forward then backward: the fused ``spa_layer`` on the first
super-layer of the full-width code (random_regular(8100, 4050, 256, dv=2),
1350 rows, dc = 4) at F = 128 with every frame active, and the bare
``spa_checknode`` on the same 172,800 gathered rows, 20 calls each by CUDA
events.  Each variant's ``spa_layer`` output is held against
``spa_layer_plain`` (exp(-cost) error; the real variants must stay within
chip_smoke.py's 1e-5).  "design" variants are alternatives the kernel
does not take; "diagnostic" ones drop work (their results are wrong) to
show what the time is spent on.  Prints one line per variant, the card's
name and power limit, and a JSON record.  No JAX is imported.
"""
from __future__ import annotations

import collections
import functools
import json
import os
import sys
import tempfile

import torch

import chip_smoke as cs
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.decoder.layered import _layer_plan
from ems_nbldpc_torch.models.code import random_regular
from ems_nbldpc_torch.ops import _build, cuda_spa

EXP = ("x[j] = expf(-fminf(x[j], kLogEps));", "x[j] = -fminf(x[j], kLogEps);")
LOG = ("y[j] = -logf(fmaxf(fmaxf(y[j] * invq, kOutFloor), kPFloor));",
       "y[j] = -fmaxf(fmaxf(y[j] * invq, kOutFloor), kPFloor);")
WHT = [("wht<PER>(x, lane, lw);", ""), ("wht<PER>(y, lane, lw);", "")]
PERM = [("w[j] = Wi[lt ^ lin_image(bas, reg_part<PER>(j, cs))];",
         "w[j] = Wi[off + reg_part<PER>(j, cs)];"),
        ("fw[j] = fw[j] * Wi[lt ^ lin_image(bas, reg_part<PER>(j, cs))];",
         "fw[j] = fw[j] * Wi[off + reg_part<PER>(j, cs)];"),
        ("y[j] = Bf[i * q + (lt ^ lin_image(bas, reg_part<PER>(j, cs)))];",
         "y[j] = Bf[i * q + off + reg_part<PER>(j, cs)];")]
VARIANTS = {  # name -> (kind, substitutions)
    "committed": ("design", []),
    # p / sum by IEEE division per symbol, not times 1 / sum
    "ieee_div": ("design", [
        ("const float inv = 1.0f / group_sum(s, lw);",
         "const float sum = group_sum(s, lw);"),
        ("x[j] = x[j] * inv;", "x[j] = x[j] / sum;")]),
    # plain stores for the write-back, not streaming ones
    "plain_stores": ("design", [
        ("#include <stdint.h>\n",
         "#include <stdint.h>\n#define __stcs(p, v) (*(p) = (v))\n")]),
    # the next row staged whole after the write-back, not half of it
    # during the inverse transforms
    "stage_after": ("design", [
        ("  if (tn < p.T) stage<FUSED>(p, S, tn, FUSED ? dc : 0, "
         "FUSED ? 2 * dc : dc,\n                             lane);\n", ""),
        ("    if (FUSED && tn < p.T) stage<FUSED>(p, S, tn, 0, p.dc, lane);",
         "    if (tn < p.T) stage<FUSED>(p, S, tn, 0, FUSED ? 2 * p.dc : p.dc,"
         " lane);")]),
    # an L2 prefetch hint on the staging copies
    "l2_prefetch": ("design", [
        ("cp.async.cg.shared.global [%0], [%1], 16;",
         "cp.async.cg.shared.global.L2::256B [%0], [%1], 16;")]),
    # no range checks of the tables' indices
    "no_index_checks": ("diagnostic", [("__trap();", ";")]),
    "no_exp_log": ("diagnostic", [EXP, LOG]),
    "no_transforms": ("diagnostic", WHT),
    "no_permutations": ("diagnostic", PERM),
    "no_math": ("diagnostic", [EXP, LOG] + WHT + PERM),
}
REPS = 20


def build_variant(name, source, root):
    """Compile ``source`` with the package's flags; returns its library."""
    src = source
    for old, new in VARIANTS[name][1]:
        if old not in src:
            raise SystemExit(f"FAIL: variant {name}: {old!r} not in source")
        src = src.replace(old, new)
    d = os.path.join(root, name)
    os.makedirs(d)
    with open(os.path.join(d, "spa_checknode.cu"), "w") as f:
        f.write(src)
    csrc, _build.CSRC = _build.CSRC, d
    try:
        cuda_spa._lib.cache_clear()
        return cuda_spa._lib()
    finally:
        _build.CSRC = csrc
        cuda_spa._lib.cache_clear()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this run needs a "
              "CUDA card", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"FAIL: unknown variants {unknown}")
    with open(os.path.join(_build.CSRC, "spa_checknode.cu")) as f:
        source = f.read()
    with tempfile.TemporaryDirectory() as root:
        libs = {n: build_variant(n, source, root) for n in names}
    graph = DeviceGraph.from_code(random_regular(8100, 4050, 256, dv=2,
                                                 seed=0))
    p = _layer_plan(graph, "cuda")[0]
    tables = (p["cols32"], p["edge_ids32"], p["coefs"], p["t_tab"],
              p["tinv_tab"])
    app, ctov, _ = cs.spa_state(128, graph.code.n + 1, graph.n_edges + 1,
                                256, p["cols"], p["edge_ids"], seed=7)
    active = torch.ones(128, dtype=torch.bool, device="cuda")
    mvc = app[:, p["cols"]] - ctov[:, p["edge_ids"]]
    mvc = (mvc - mvc.min(dim=-1, keepdim=True).values).reshape(-1, 4, 256)
    want = app.clone(), ctov.clone()
    cuda_spa.spa_layer_plain(*want, active, *tables)
    err, times = {}, collections.defaultdict(list)
    for order in (names, names[::-1]):
        for name in order:
            cuda_spa._lib = functools.lru_cache(None)(
                lambda lib=libs[name]: lib)
            a, c = app.clone(), ctov.clone()
            cuda_spa.spa_layer(a, c, active, *tables)
            torch.cuda.synchronize()
            err[name] = max(
                float((torch.exp(-x) - torch.exp(-y)).abs().max())
                for x, y in zip((a, c), want))
            fused = cs.time_ms(lambda: cuda_spa.spa_layer(a, c, active,
                                                          *tables), REPS)
            bare = cs.time_ms(lambda: cuda_spa.spa_checknode(mvc,
                                                             *tables[2:]),
                              REPS)
            times[name].append((fused, bare))
            del a, c
    for name in names:
        f, b = zip(*times[name])
        print(f"{name:16s} {VARIANTS[name][0]:10s} spa_layer F=128 "
              + " / ".join(f"{v:.4f}" for v in f) + " ms; spa_checknode "
              "T=172800 " + " / ".join(f"{v:.4f}" for v in b)
              + f" ms; exp(-cost) err vs plain {err[name]:.3e}", flush=True)
    for name in names:
        if VARIANTS[name][0] == "design" and not err[name] <= 1e-5:
            raise SystemExit(f"FAIL: design variant {name} disagrees with "
                             f"the plain version ({err[name]:.3e})")
    print(cs.card_line())
    print(json.dumps({"variants": {n: {
        "kind": VARIANTS[n][0], "spa_layer_ms": [t[0] for t in times[n]],
        "spa_checknode_ms": [t[1] for t in times[n]],
        "exp_cost_err": err[n]} for n in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
