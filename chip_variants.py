#!/usr/bin/env python3
"""Time design variants of the SPA, syndrome, bubble, list and EMS kernels
against their committed sources, on one CUDA card.

    python3 chip_variants.py                       # every SPA variant
    python3 chip_variants.py NAME ...              # some of them
    python3 chip_variants.py --syndrome [NAME ...] # the syndrome kernel's
    python3 chip_variants.py --syndrome --build    # build them, time none
    python3 chip_variants.py --syndrome --source PATH [NAME ...]
                                       # variants of another version of it
    python3 chip_variants.py --bubble [NAME ...]   # the bubble kernel's (K9)
    python3 chip_variants.py --bubble --source PATH committed
                                       # another version of it (one without
                                       # the fused entry: the bare one only)
    python3 chip_variants.py --list [NAME ...]     # the list kernel's (K3)
    python3 chip_variants.py --list --source PATH [NAME ...]
    python3 chip_variants.py --list committed committed@PATH
                                       # NAME@PATH: a variant of another
                                       # version of it, timed in the turns
    python3 chip_variants.py --cn [--sass] [NAME[@PATH] ...]
                                       # the EMS kernel's (K1); --sass
                                       # prints each build's opcode counts

A variant is a kernel source of ``ems_nbldpc_torch/csrc/`` with a few text
substitutions, written to a temporary directory, built by ``ops/_build.py``
(into ``ems_nbldpc_torch/build/``, named by its digest) and loaded in place
of the committed library.  All variants of a kernel are timed in one
process, in turns, forward then backward, on the first super-layer of the
full-width code (random_regular(8100, 4050, 256, dv=2), 1350 rows,
dc = 4) at F = 128 with every frame active, 20 calls each by CUDA events:

* SPA: the fused ``spa_layer`` and the bare ``spa_checknode`` on the same
  172,800 gathered rows; each variant's ``spa_layer`` output is held
  against ``spa_layer_plain`` (exp(-cost) error; the real variants must
  stay within chip_smoke.py's 1e-5).
* syndrome (the default table, C = 993, nm = 32, bayes and presort on):
  the fused ``syndrome_layer`` and the bare ``syndrome_rows`` on the same
  gathered rows; each variant's ``syndrome_layer`` output is held against
  ``syndrome_layer_plain`` (the real variants must equal it bit for bit).
  The variants are built in parallel.
* bubble (nm = 32, nbOper = 64, offset 0.3, the 8-bubble): the fused
  ``bubble_layer`` and the bare ``bubble_rows`` on the same gathered
  rows, and ``bubble_layer`` with nbOper = 0; each variant's
  ``bubble_layer`` output is held against ``bubble_layer_plain`` (the real
  variants must equal it bit for bit).  Built in parallel.
* list (nm = 32, nbOper = 64, offset 0.3): ``list_layer`` on a bf16 and
  an f32 compressed state (``chip_smoke.list_state``, "decoder"), the
  staircase (the fast step) and beside it the exact merge (nbOper = 0,
  the general step); each variant's output is held against
  ``list_layer_plain`` in both modes (the real variants must equal it bit
  for bit but the padding column and edge).  Built in parallel.

* K1 (``--cn``): ``ems_rows`` in the dense mode at the layered shape
  (nm = q, no truncation: the CLI default's call) and from the workspace
  (dc = 40, 4000 rows, nm = 200), in the list mode (nm = 32) at the
  layered and flooding shapes, and the bare ``fb_checknode`` on f32 and
  bf16 rows (nm = 32); each variant's outputs are held against their
  plain versions (the real variants must equal them bit for bit).  Built
  in parallel.

"design" variants are alternatives the kernel does not take; "diagnostic"
ones drop work (their results are wrong) to show what the time is spent
on.  Prints one line per variant, the card's name and power limit, and a
JSON record.  No JAX is imported.
"""
from __future__ import annotations

import collections
import concurrent.futures
import functools
import json
import os
import re
import sys
import tempfile

import torch

import chip_smoke as cs
from ems_nbldpc_torch.decoder.flooding import (_cn_row_tables,
                                               _syndrome_tables, syn_key)
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.decoder.layered import _layer_plan
from ems_nbldpc_torch.models.code import random_regular
from ems_nbldpc_torch.ops import (_build, cuda_bubble, cuda_cn, cuda_list,
                                  cuda_spa, cuda_syndrome, listcn)

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


SYN_G0 = ("const unsigned g0 = LA[et * p.nm].y;",
          "const unsigned g0 = LA[et * p.nm].y & (q - 1);")
SYN_VARIANTS = {  # name -> (kind, substitutions, each of every occurrence)
    "committed": ("design", []),
    # the list selections from the lanes' smallest up, not from their
    # second smallest when that holds at most nm - 1 keys
    "no_list_floor": ("design", [("  if (k < 32) {", "  if (false) {")]),
    # 8 or 32 masked configs a lane in registers, not 16 (8: the rest of
    # the default table's 489 spill to shared memory)
    "regs_8": ("design", [("constexpr int REG_CFG = 16;",
                           "constexpr int REG_CFG = 8;")]),
    "regs_32": ("design", [("constexpr int REG_CFG = 16;",
                            "constexpr int REG_CFG = 32;")]),
    # at most 102 registers a thread, so that 20 warps fit an SM's
    "regs_cap": ("design", [
        ("__global__ void syndrome_kernel(const Params p) {",
         "__global__ void __launch_bounds__(128, 5)\n"
         "    syndrome_kernel(const Params p) {")]),
    # plain stores for the write-back, not streaming ones
    "plain_stores": ("design", [
        ("#include <stdint.h>\n",
         "#include <stdint.h>\n#define __stcs(p, v) (*(p) = (v))\n")]),
    # what the time is spent on (diagnostics that leave list entries
    # unset keep the bucket ids in range: the first row finds shared
    # memory as it was left)
    "no_sat_keep_selections": ("diagnostic", [
        ("const unsigned sb = warp_search(lo, top, k,",
         "const unsigned sb = warp_search(lo, lo, k,"),
        ("thr = warp_search(lo, top, keep - 1,",
         "thr = warp_search(lo, lo, keep - 1,")]),
    "no_list_ranks": ("diagnostic", [
        ("#pragma unroll 4\n    for (int i = 0; i < nm; ++i) {",
         "    for (int i = 0; i < 0; ++i) {"),
        ("      rank[u] = 0;",
         "      rank[u] = min(j0 + 32 * u, dc * nm - 1) % nm;"), SYN_G0]),
    "no_bucket_passes": ("diagnostic", [
        ("    if (kc[j] != NONE) atomicMin(&B1[bb[j]], kc[j]);", "    ;"),
        ("  if (p.bayes) {\n    unsigned m[REG_CFG];",
         "  if (false) {\n    unsigned m[REG_CFG];")]),
    "no_positions": ("diagnostic", [
        ("    for (int t = 0; t < dc; ++t)\n      position<",
         "    for (int t = 0; t < 0; ++t)\n      position<")]),
}


def variant_source(name, variants, source, root, file):
    """Write ``variants[name]``'s source under ``root``; returns its path."""
    src = source
    for old, new in variants[name][1]:
        if old not in src:
            raise SystemExit(f"FAIL: variant {name}: {old!r} not in source")
        src = src.replace(old, new)
    d = os.path.join(root, name)
    os.makedirs(d)
    path = os.path.join(d, file)
    with open(path, "w") as f:
        f.write(src)
    return path


def layer_kernel_report(log):
    """ptxas' spill and register lines of syndrome_kernel<8, true> (the
    layered call's instance) from a verbose build's log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "ILi8ELb1E" in line:
            return "; ".join(x.split(":", 1)[-1].strip()
                             for x in lines[i + 1:i + 4]
                             if "spill" in x or "registers" in x)
    return "not found"


def syndrome_main(names) -> int:
    """Time the syndrome kernel's variants ``names`` (see the module
    docstring); with ``--build`` first, build them only (in parallel: the
    digest-named libraries then serve later runs of the same call)."""
    build_only = names[:1] == ["--build"]
    names = names[1:] if build_only else names
    file = "syndrome_checknode.cu"
    base = os.path.join(_build.CSRC, file)
    if names[:1] == ["--source"]:
        base, names = names[1], names[2:]
    names = names or list(SYN_VARIANTS)
    unknown = [n for n in names if n not in SYN_VARIANTS]
    if unknown:
        raise SystemExit(f"FAIL: unknown syndrome variants {unknown}")
    with open(base) as f:
        source = f.read()
    print(f"variants of {base}", flush=True)
    with tempfile.TemporaryDirectory() as root:
        paths = {n: variant_source(n, SYN_VARIANTS, source, root, file)
                 for n in names}
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            built = {n: pool.submit(_build.build, "syndrome_checknode", True,
                                    paths[n]) for n in names}
            built = {n: fut.result() for n, fut in built.items()}
    for n, (_, seconds, log) in built.items():
        print(f"built {n} in {seconds:.1f} s; syndrome_kernel<8, true>: "
              f"{layer_kernel_report(log)}", flush=True)
    if build_only:
        return 0
    libs = {n: cuda_syndrome.bind(built[n][0]) for n in names}
    graph = DeviceGraph.from_code(random_regular(8100, 4050, 256, dv=2,
                                                 seed=0))
    p = _layer_plan(graph, "cuda")[0]
    layer = (p["cols32"], p["edge_ids32"], p["rot_in8"], p["rot_out8"],
             p["valid"])
    tabs = _syndrome_tables(4, 32, syn_key({}), "cuda")
    cn = (tabs["table"], tabs["kth"], 32, cs.OFFSET, True, True)
    app, ctov, _ = cs.spa_state(128, graph.code.n + 1, graph.n_edges + 1,
                                256, p["cols"], p["edge_ids"], seed=7)
    active = torch.ones(128, dtype=torch.bool, device="cuda")
    mvc = app[:, p["cols"]] - ctov[:, p["edge_ids"]]
    mvc = (mvc - mvc.min(dim=-1, keepdim=True).values).reshape(-1, 4, 256)
    want = app.clone(), ctov.clone()
    cuda_syndrome.syndrome_layer_plain(*want, active, *layer, *cn)
    exact, times = {}, collections.defaultdict(list)
    for order in (names, names[::-1]):
        for name in order:
            cuda_syndrome._lib = functools.lru_cache(None)(
                lambda lib=libs[name]: lib)
            a, c = app.clone(), ctov.clone()
            cuda_syndrome.syndrome_layer(a, c, active, *layer, *cn,
                                         tabs["lists"])
            torch.cuda.synchronize()
            exact[name] = torch.equal(a, want[0]) and torch.equal(c, want[1])
            print(f"{name}: ran, bit-exact vs plain {exact[name]}",
                  flush=True)
            fused = cs.time_ms(lambda: cuda_syndrome.syndrome_layer(
                a, c, active, *layer, *cn, tabs["lists"]), REPS)
            bare = cs.time_ms(lambda: cuda_syndrome.syndrome_rows(
                mvc, *layer[2:], *cn, tabs["lists"]), REPS)
            times[name].append((fused, bare))
            del a, c
    for name in names:
        f, b = zip(*times[name])
        print(f"{name:18s} {SYN_VARIANTS[name][0]:10s} syndrome_layer F=128 "
              + " / ".join(f"{v:.4f}" for v in f) + " ms; syndrome_rows "
              "T=172800 " + " / ".join(f"{v:.4f}" for v in b)
              + f" ms; bit-exact vs plain {exact[name]}", flush=True)
    for name in names:
        if SYN_VARIANTS[name][0] == "design" and not exact[name]:
            raise SystemExit(f"FAIL: design variant {name} disagrees with "
                             f"the plain version")
    print(cs.card_line())
    print(json.dumps({"syndrome_variants": {n: {
        "kind": SYN_VARIANTS[n][0],
        "syndrome_layer_ms": [t[0] for t in times[n]],
        "syndrome_rows_ms": [t[1] for t in times[n]],
        "bit_exact": exact[n]} for n in names}}))
    return 0


BUB_VARIANTS = {  # name -> (kind, substitutions, each of every occurrence)
    "committed": ("design", []),
    # every list by the bisection of the design before this one (32 warp
    # reductions, then a ballot take and a rank count), not the register
    # top-nm (the nm > 32 path)
    "bisection": ("design", [("constexpr int TOPNM_MAX = 32;",
                              "constexpr int TOPNM_MAX = 0;")]),
    # the top-nm's candidates always by a bitonic sort and merge, or up to
    # 4 of them inserted singly, not up to 8
    "no_insert": ("design", [("constexpr int INSERT_MAX = 8;",
                              "constexpr int INSERT_MAX = 0;")]),
    "insert_4": ("design", [("constexpr int INSERT_MAX = 8;",
                             "constexpr int INSERT_MAX = 4;")]),
    # rows a warp for 24 warps an SM (4 rows, at most 80 registers a
    # thread) or 8 (16 rows, 255 registers), not 16 (8 rows, 128)
    "warps_24": ("design", [("constexpr int TARGET_WARPS = 16;",
                             "constexpr int TARGET_WARPS = 24;")]),
    "warps_8": ("design", [("constexpr int TARGET_WARPS = 16;",
                            "constexpr int TARGET_WARPS = 8;")]),
    # a slot's loads issued while the slot before it selects, not after
    "pipelined": ("design", [
        ("    if (nm <= TOPNM_MAX) {",
         "    if (k + 1 < dc) real = load_in<PER, LAYER>(p, row, k + 1, lane, "
         "a, c, rin);\n    if (nm <= TOPNM_MAX) {"),
        ("    __syncwarp();\n    if (k + 1 < dc) real = load_in<PER, LAYER>("
         "p, row, k + 1, lane, a, c, rin);\n  }\n}",
         "    __syncwarp();\n  }\n}")]),
    # 12 warps an SM (12 rows a warp, at most 168 registers a thread), not
    # 16 (8 rows, 128)
    "warps_12": ("design", [("constexpr int TARGET_WARPS = 16;",
                             "constexpr int TARGET_WARPS = 12;")]),
    # 4 rows a warp at the same 16 warps an SM: the rows that steps 6-9
    # read again stay in L2 more often, the merges use 8 lanes of 32
    "rows_4": ("design", [("constexpr int MAX_R = 16; ",
                           "constexpr int MAX_R = 4; ")]),
    # streaming stores for the write-back, not plain ones
    "streaming_stores": ("design", [
        ("      crow[s] = o;\n      arow[s] = __fadd_rn(mvc[i], o);",
         "      __stcs(crow + s, o);\n"
         "      __stcs(arow + s, __fadd_rn(mvc[i], o));")]),
    # what the time is spent on (their results are wrong)
    "no_selection": ("diagnostic", [
        ("const u64 t = top_nm<PER>(key, nm, lane);",
         "const u64 t = key[0];")]),
    "no_merges": ("diagnostic", [
        ("for (int op = 0; op < nb_oper; ++op) {",
         "for (int op = 0; op < 0; ++op) {")]),
    "no_refetch": ("diagnostic", [
        ("    load_slot<PER>(p, f, col, edge, lane, on, a, c);\n  }",
         "#pragma unroll\n    for (int i = 0; i < PER; ++i) a[i] = c[i] = "
         "0.0f;\n  }")]),
    "no_writeback": ("diagnostic", [
        ("      crow[s] = o;\n      arow[s] = __fadd_rn(mvc[i], o);",
         "      if (o == -1.0f) crow[s] = __fadd_rn(mvc[i], o);")]),
}


def bare_bind(path):
    """A library of K9 with the bare entry only (the design before the
    fused one): ``bubble_rows_launch`` declared as ``cuda_bubble.bind``
    declares it."""
    import ctypes
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bubble_rows_launch.argtypes = [ptr, ptr, i64, i32, i32, i32, i32,
                                       ptr, ptr, ptr, i64, i32, i32,
                                       ctypes.c_float, i32, ptr]
    lib.bubble_rows_launch.restype = i32
    return lib


def bubble_kernel_report(log):
    """ptxas' spill and register lines of bubble_kernel<8, 8, true> (the
    layered call's instance) from a verbose build's log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if ("Compiling entry function" in line and "bubble_kernel" in line
                and "ILi8ELi8ELb1E" in line):
            return "; ".join(x.split(":", 1)[-1].strip()
                             for x in lines[i + 1:i + 4]
                             if "spill" in x or "registers" in x)
    return "not found"


def bubble_main(names) -> int:
    """Time the bubble kernel's variants ``names`` (see the module
    docstring)."""
    file = "bubble_checknode.cu"
    base = os.path.join(_build.CSRC, file)
    if names[:1] == ["--source"]:
        base, names = names[1], names[2:]
    names = names or list(BUB_VARIANTS)
    unknown = [n for n in names if n not in BUB_VARIANTS]
    if unknown:
        raise SystemExit(f"FAIL: unknown bubble variants {unknown}")
    with open(base) as f:
        source = f.read()
    print(f"variants of {base}", flush=True)
    with tempfile.TemporaryDirectory() as root:
        paths = {n: variant_source(n, BUB_VARIANTS, source, root, file)
                 for n in names}
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            built = {n: pool.submit(_build.build, "bubble_checknode", True,
                                    paths[n]) for n in names}
            built = {n: fut.result() for n, fut in built.items()}
    fused = "bubble_layer_launch" in source
    for n, (_, seconds, log) in built.items():
        print(f"built {n} in {seconds:.1f} s; bubble_kernel<8, 8, true>: "
              f"{bubble_kernel_report(log)}", flush=True)
    libs = {n: (cuda_bubble.bind if fused else bare_bind)(built[n][0])
            for n in names}
    graph = DeviceGraph.from_code(random_regular(8100, 4050, 256, dv=2,
                                                 seed=0))
    p = _layer_plan(graph, "cuda")[0]
    layer = (p["cols32"], p["edge_ids32"], p["rot_in8"], p["rot_out8"],
             p["valid"])
    cn = (cs.BUBBLE_NM, cs.BUBBLE_OPS, cs.OFFSET, True, True, "8")
    no_steps = (cs.BUBBLE_NM, 0) + cn[2:]
    app, ctov, _ = cs.spa_state(128, graph.code.n + 1, graph.n_edges + 1,
                                256, p["cols"], p["edge_ids"], seed=7)
    active = torch.ones(128, dtype=torch.bool, device="cuda")
    mvc = app[:, p["cols"]] - ctov[:, p["edge_ids"]]
    mvc = (mvc - mvc.min(dim=-1, keepdim=True).values).reshape(-1, 4, 256)
    want = app.clone(), ctov.clone()
    cuda_bubble.bubble_layer_plain(*want, active, *layer, *cn)
    want_rows = cs.bubble_rows_plain(mvc, *layer[2:], *cn)
    exact, times = {}, collections.defaultdict(list)
    for order in (names, names[::-1]):
        for name in order:
            cuda_bubble._lib = functools.lru_cache(None)(
                lambda lib=libs[name]: lib)
            a, c = app.clone(), ctov.clone()
            got_rows = cuda_bubble.bubble_rows(mvc, *layer[2:], *cn)
            if fused:
                cuda_bubble.bubble_layer(a, c, active, *layer, *cn)
            torch.cuda.synchronize()
            exact[name] = torch.equal(got_rows, want_rows) and (
                not fused or torch.equal(a, want[0])
                and torch.equal(c, want[1]))
            print(f"{name}: ran, bit-exact vs plain {exact[name]}",
                  flush=True)
            t = [cs.time_ms(lambda: cuda_bubble.bubble_rows(
                mvc, *layer[2:], *cn), REPS)]
            if fused:
                t += [cs.time_ms(lambda: cuda_bubble.bubble_layer(
                          a, c, active, *layer, *cn), REPS),
                      cs.time_ms(lambda: cuda_bubble.bubble_layer(
                          a, c, active, *layer, *no_steps), REPS)]
            times[name].append(t)
            del a, c, got_rows
    for name in names:
        cols = list(zip(*times[name]))
        print(f"{name:18s} {BUB_VARIANTS[name][0]:10s} bubble_rows T=172800 "
              + " / ".join(f"{v:.4f}" for v in cols[0]) + " ms"
              + ("; bubble_layer F=128 " + " / ".join(f"{v:.4f}"
                                                      for v in cols[1])
                 + " ms, nbOper = 0 " + " / ".join(f"{v:.4f}"
                                                   for v in cols[2])
                 + " ms" if fused else "")
              + f"; bit-exact vs plain {exact[name]}", flush=True)
    for name in names:
        if BUB_VARIANTS[name][0] == "design" and not exact[name]:
            raise SystemExit(f"FAIL: design variant {name} disagrees with "
                             f"the plain version")
    print(cs.card_line())
    print(json.dumps({"bubble_variants": {n: {
        "kind": BUB_VARIANTS[n][0],
        "bubble_rows_ms": [t[0] for t in times[n]],
        "bubble_layer_ms": [t[1] for t in times[n]] if fused else None,
        "bubble_layer_no_steps_ms": [t[2] for t in times[n]] if fused
        else None,
        "bit_exact": exact[n]} for n in names}}))
    return 0


# an exact selection's stand-in: entry e the id e at value e, kept
EXACT_FAKE = ("(out[0] = lane, out[1] = lane + 32, full[0] = "
              "__float_as_uint(lane), full[1] = __float_as_uint(lane + 32), "
              "true)")

# the former general step's tail, in its merge just before its kernel
FORMER_TAIL = ("  if (nh < nm) exact_tail(la, lb, lo, tab, tab + TAB, nh, nm, "
               "lane);\n  __syncwarp();\n}\n\ntemplate <class ST>\n")
# that line commented out
FORMER_NO_TAIL = FORMER_TAIL.replace("  if (nh < nm) exact_tail", "  //")
LIST_VARIANTS = {  # name -> (kind, substitutions, each of every occurrence)
    "committed": ("design", []),
    # 6 or 4 blocks an SM (at most 80 or 128 registers a thread), not 8 (64)
    "blocks_6": ("design", [("constexpr int BLOCKS_SM = 8;",
                             "constexpr int BLOCKS_SM = 6;")]),
    "blocks_4": ("design", [("constexpr int BLOCKS_SM = 8;",
                             "constexpr int BLOCKS_SM = 4;")]),
    # every selection over all 256 keys (the 64-key form, out of line)
    "no_fast_path": ("design", [("  if (nm <= 32) {\n    out[0] = top_fast",
                                 "  if (false) {\n    out[0] = top_fast")]),
    # the merges and the slow selections inlined where they are called
    "inline_merges": ("design", [
        ("__device__ __noinline__ void merge(", "__device__ void merge(")]),
    "inline_slow": ("design", [
        ("__device__ __noinline__ void select_slow(",
         "__device__ __forceinline__ void select_slow(")]),
    # the staircase's candidates four a lane in flight
    "unroll_candidates": ("design", [
        ("  for (int c = lane; c < npairs; c += 32) {",
         "#pragma unroll 4\n  for (int c = lane; c < npairs; c += 32) {")]),
    # the bf16 roundings of mvc and the expansions two values a conversion
    "paired_roundings": ("design", [
        ("  for (int i = 0; i < 8; ++i) v[i] = from_bits(bf16_raw(v[i]));",
         "  for (int i = 0; i < 8; i += 2) {\n"
         "    const unsigned u = bf16x2(v[i], v[i + 1]);\n"
         "    v[i] = __uint_as_float(u << 16);\n"
         "    v[i + 1] = __uint_as_float(u & 0xffff0000u);\n  }")]),
    # APP rows by scalar loads and stores, not 8- / 16-byte vectors
    "scalar_rows": ("design", [("  p.vec = p.q >= 4 &&",
                                "  p.vec = false &&")]),
    # warp minima and maxima by 5 shuffles, not one redux.sync
    "shuffle_reductions": ("design", [
        ("  return fval(__reduce_min_sync(FULL, fkey(v)));",
         "  for (int o = 16; o > 0; o >>= 1)\n"
         "    v = fminf(v, __shfl_xor_sync(FULL, v, o));\n  return v;"),
        ("  return fval(__reduce_max_sync(FULL, fkey(v)));",
         "  for (int o = 16; o > 0; o >>= 1)\n"
         "    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));\n  return v;")]),
    # what the time is spent on (their results are wrong)
    # no key inserted after the 128-key fast path (exact where none is due)
    "fast_only": ("diagnostic", [
        ("    insert_rest(k, out[0], nm, lane);\n", "")]),
    "no_merges": ("diagnostic", [("dc >= 3 && u <= dc - 2;",
                                  "dc >= 3 && u <= 0;")]),
    "no_candidates": ("diagnostic", [
        ("for (int c = lane; c < npairs; c += 32) {",
         "for (int c = lane; c < 0; c += 32) {")]),
    "no_selections": ("diagnostic", [
        ("select_nm(k, out, tab, nm, lane)",
         "(out[0] = k[0], out[1] = k[1])"),
        ("select_nm(key, out, tab, nm, lane)",
         "(out[0] = key[0], out[1] = key[1])")]),
    "no_rotations": ("diagnostic", [
        ("  return __shfl_sync(FULL, table, g & 15) ^\n"
         "         __shfl_sync(FULL, table, 16 | (g >> 4 & 15));",
         "  return g;")]),
    "no_writeback": ("diagnostic", [
        ("      store_row(app + (f * p.app_rows + col) * q, o, q, vec, lane);",
         "      if (o[0] == -1.0f)\n"
         "        store_row(app + (f * p.app_rows + col) * q, o, q, vec, "
         "lane);")]),
    # the exact mode (list_kernel<ST, true>) on an f32 state at 8 blocks an
    # SM (64 registers, not 80), on a bf16 one at 6 (80, not 64)
    "exact_f32_blocks_8": ("design", [
        ("constexpr int EXACT_BLOCKS_SM_F32 = 6;",
         "constexpr int EXACT_BLOCKS_SM_F32 = 8;")]),
    "exact_bf16_blocks_6": ("design", [
        ("constexpr int EXACT_BLOCKS_SM_BF16 = 8;",
         "constexpr int EXACT_BLOCKS_SM_BF16 = 6;")]),
    # the exact mode's row widths: packed into one register, or computed
    # in each merge (32-bit division) and not kept; on a bf16 state at 7
    # blocks an SM (72 registers)
    "exact_packed_rows": ("design", [
        ("      merge_exact(x, y, o, tab, pairs, p.npairs, nm, w0, w1, lane);",
         "      merge_exact(x, y, o, tab, pairs, p.npairs, nm, wpack & 0xff,"
         " wpack >> 8, lane);"),
        ("  const int w1 = row_width(lane + 32, nm, budget);\n",
         "  const int w1 = row_width(lane + 32, nm, budget);\n"
         "  const int wpack = w0 | w1 << 8;\n")]),
    "exact_rows_inside": ("design", [
        ("      merge_exact(x, y, o, tab, pairs, p.npairs, nm, w0, w1, lane);",
         "      merge_exact(x, y, o, tab, pairs, p.npairs, nm, 0, 0, lane);"),
        ("  const int budget = table_budget(nm, 0);  // the pairs' staircase\n",
         "  const int budget = table_budget(nm, 0);  // the pairs' staircase\n"
         "  w0 = min(nm, budget / (lane + 1));\n"
         "  w1 = min(nm, budget / (lane + 33));\n")]),
    "exact_bf16_blocks_7": ("design", [
        ("constexpr int EXACT_BLOCKS_SM_BF16 = 8;",
         "constexpr int EXACT_BLOCKS_SM_BF16 = 7;")]),
    # its merges' first pass over {(i+1)(j+1) <= nm}, not 2 nm
    "exact_first_nm": ("design", [
        ("  return nboper >= 1 ? nboper : 2 * nm;",
         "  return nboper >= 1 ? nboper : nm;")]),
    # what its time is spent on (their results are wrong): its truncations'
    # and its merges' selections (the merges' bound then prunes everything
    # past the first pass), the merges' candidates (and the rest and the
    # tail, which an empty table would call for), the check of the 32-bit
    # selections and the sorts it calls for, the candidates past the
    # staircase
    "exact_no_trunc_selections": ("diagnostic", [
        ("  const bool kept = select_exact(tab, ABSENT, out, full, scr, nm, "
         "nm, lane);", "  const bool kept = " + EXACT_FAKE + ";"),
        ("    select_nm(k, out, scr, nm, lane);\n",
         "    out[0] = __float_as_uint(lane) | lane;\n"
         "    out[1] = __float_as_uint(lane + 32) | (lane + 32);\n")]),
    "exact_no_merge_selections": ("diagnostic", [
        ("    kept = select_exact(tab, BIG_BITS, out, full, scr, n, nm, "
         "lane);", "    kept = " + EXACT_FAKE + ";")]),
    "exact_no_candidates": ("diagnostic", [
        ("  for (int c = lane; c < npairs; c += 32) {\n"
         "    const unsigned p = pairs[c];\n"
         "    const uint2 a",
         "  for (int c = lane; c < 0; c += 32) {\n"
         "    const unsigned p = pairs[c];\n"
         "    const uint2 a"),
        ("    if (nh >= nm) {\n      const unsigned bound",
         "    if (true) {\n      const unsigned bound"),
        ("        for (int j = j0; j < nm; ++j) {",
         "        for (int j = nm; j < nm; ++j) {"),
        ("  if (nh < nm) exact_tail(la, lb, lo, tab, scr, nh, nm, lane);",
         "")]),
    "exact_no_check": ("diagnostic", [
        ("  return exact_ok(vals, lim, out, full, n, nm, lane);",
         "  return true;")]),
    "exact_no_pass2": ("diagnostic", [
        ("      if (!__any_sync(FULL, first <= bound)) break;",
         "      break;")]),
    # the general step: its exact merges in the list form at nm = q too
    # (the pruned merge), not dense
    "exact_list_form": ("design", [("(q == TAB && nm == q && dc >= 3)",
                                    "(false)")]),
    # the general step's stored lists loaded 8 entries a lane at once, then
    # folded (more registers: slower, 8.87 against 8.46 ms at nm = q)
    "general_cv_batched": ("design", [
        ("""      fill_tab(tab, empty, lane);
      __syncwarp();
      for (int e = lane; e < nm; e += 32)
        atomicMin(tab + p.cv_g[ce * nm + e], fkey(ld(cv_v + ce * nm + e)));
      const float sat = ld(cv_sat + ce);
      __syncwarp();
      unsigned tt[8];
      read_tab(tab, tt, lane);
      float c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) c[i] = fminf(fval(tt[i]), sat);
      rnd8<ST>(c);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __fsub_rn(a[i], c[i]);
      rnd8<ST>(a);
      float mn = __int_as_float(0x7f800000);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (sym(lane, i) < q) mn = fminf(mn, a[i]);
      mn = warp_min(mn);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __fsub_rn(a[i], mn);
      rnd8<ST>(a);
      store_row(mvc + k * q, a, q, q >= 4, lane);
      __syncwarp();
    }""", """      unsigned cvk[8], cvg[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = lane + 32 * u;
        if (e < nm) {
          cvg[u] = p.cv_g[ce * nm + e];
          cvk[u] = fkey(ld(cv_v + ce * nm + e));
        }
      }
      const float sat = ld(cv_sat + ce);
      fill_tab(tab, empty, lane);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (lane + 32 * u < nm) atomicMin(tab + cvg[u], cvk[u]);
      __syncwarp();
      unsigned tt[8];
      read_tab(tab, tt, lane);
      float c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) c[i] = fminf(fval(tt[i]), sat);
      rnd8<ST>(c);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __fsub_rn(a[i], c[i]);
      rnd8<ST>(a);
      float mn = __int_as_float(0x7f800000);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (sym(lane, i) < q) mn = fminf(mn, a[i]);
      mn = warp_min(mn);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __fsub_rn(a[i], mn);
      rnd8<ST>(a);
      store_row(mvc + k * q, a, q, q >= 4, lane);
      __syncwarp();
    }""")]),
    # no row of the dense form run again through the list form (wrong on
    # a row with a tail: "padded256_bf16" shows that the rerun runs)
    "general_no_tail_rerun": ("diagnostic", [
        ("          tail = h.x < nm || h.y < nm;", "          tail = false;")]),
    # what its time is spent on (their results are wrong): the dense
    # merges' candidates (and the tail they would then call for), the
    # dense form's output sorts, the staircase's selections, its merges'
    # candidates
    "general_no_dense_merges": ("diagnostic", [
        ("  for (int c = 0; c < 32; ++c) {", "  for (int c = 0; c < 0; ++c) {"),
        ("          tail = h.x < nm || h.y < nm;", "          tail = false;")]),
    "general_no_output_sorts": ("diagnostic", [
        ("          select_exact_out(reinterpret_cast<const unsigned*>(dv + "
         "src * q),\n                           BIG_BITS, nm, tab2, lane);\n",
         "")]),
    "general_no_stair_selections": ("diagnostic", [
        ("  select_stair_out(tab, nm, lo, lane);\n", ""),
        ("        select_stair_out(tab, nm, lk, lane);\n", "")]),
    "general_no_stair_candidates": ("diagnostic", [
        ("  for (int c = lane; c < npairs; c += 32) {\n"
         "    const unsigned p = pairs[c];\n"
         "    const unsigned a = la[p >> 8], b = lb[p & 0xff];\n"
         "    atomicMin(tab + ((a ^ b) & 0xff),\n"
         "              bf16_bits(__fadd_rn(sum_value(a), sum_value(b))));\n"
         "  }\n  __syncwarp();\n  select_stair_out",
         "  for (int c = lane; c < 0; c += 32) {\n"
         "    const unsigned p = pairs[c];\n"
         "    const unsigned a = la[p >> 8], b = lb[p & 0xff];\n"
         "    atomicMin(tab + ((a ^ b) & 0xff),\n"
         "              bf16_bits(__fadd_rn(sum_value(a), sum_value(b))));\n"
         "  }\n  __syncwarp();\n  select_stair_out")]),
    # the former general step (list_general_kernel before its dense
    # redesign: git show 101a6c6:<the source>, as NAME@PATH): without its
    # truncations' 256-key 64-bit sorts, without its merges' sorts,
    # without its merges' candidates (and the tail, which would count them
    # all), without the tail
    "former_general_no_trunc_sorts": ("diagnostic", [
        ("      sort256(key, lane);\n", "")]),
    "former_general_no_merge_sorts": ("diagnostic", [
        ("  sort256(k, lane);\n  const int nh", "  const int nh")]),
    "former_general_no_candidates": ("diagnostic", [
        ("    for (int j = lane; j < wi; j += 32) {",
         "    for (int j = lane; j < 0; j += 32) {"),
        (FORMER_TAIL, FORMER_NO_TAIL)]),
    "former_general_no_tail": ("diagnostic", [
        (FORMER_TAIL, FORMER_NO_TAIL)]),
}


def applies(name, variants, source):
    """Whether every substitution of ``variants[name]`` finds its text."""
    return all(old in source for old, _ in variants[name][1])


def entry_reports(log):
    """ptxas' register and spill lines of each kernel entry in a verbose
    build's log, by the entry's demangled-enough name."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?([A-Za-z_]+kernel)I",
                      line)
        if m:
            flags = re.findall(r"Lb([01])E", line)
            name = m.group(1) + ("<bf16" if "bfloat16" in line
                                 else "<float") + "".join(
                                     ", " + ("true" if b == "1" else "false")
                                     for b in flags) + ">"
            out[name] = "; ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                if "spill" in x or "registers" in x)
    return out


def list_kind(label):
    """The kind of the list variant a label (NAME or NAME@PATH) names."""
    return LIST_VARIANTS[label.split("@")[0]][0]


# the general step's shapes (--list --general): label -> (layer, nm,
# nbOper, state dtype); "layer 0" is the full-width code's first
# super-layer (1350 rows, dc = 4) at F = 128, "dc 34" a random layer of 20
# rows of degree 34 (the workspace), "padded" one of 1350 rows of degree 4
# with half the slots padded (merges of neutral lists: the dense form's
# tails)
GENERAL_SHAPES = {
    "exact256_bf16": ("layer 0", 256, 0, torch.bfloat16),
    "exact256_f32": ("layer 0", 256, 0, torch.float32),
    "exact128_bf16": ("layer 0", 128, 0, torch.bfloat16),
    "exact96_bf16": ("layer 0", 96, 0, torch.bfloat16),
    "exact65_bf16": ("layer 0", 65, 0, torch.bfloat16),
    "exact128_f32": ("layer 0", 128, 0, torch.float32),
    "exact255_bf16": ("layer 0", 255, 0, torch.bfloat16),
    "stair65_bf16": ("layer 0", 65, 64, torch.bfloat16),
    "stair128_bf16": ("layer 0", 128, 256, torch.bfloat16),
    "ws34_exact256_f32": ("dc 34", 256, 0, torch.float32),
    "padded256_bf16": ("padded", 256, 0, torch.bfloat16),
}
GENERAL_REPS = 5


def general_cases(graph, shapes):
    """For each general shape: (layer tables, cn, a maker of the F = 128
    state to time, a 4-frame state and its plain result to check
    against)."""
    p = _layer_plan(graph, "cuda")[0]
    layers = {"layer 0": ((p["cols32"], p["edge_ids32"], p["rc_in"],
                           p["rc_out"], p["valid"]),
                          graph.code.n + 1, graph.n_edges + 1),
              "dc 34": cs.odd_list_layer(20, 34, 256, 0, seed=34),
              "padded": cs.odd_list_layer(1350, 4, 256, 2700, seed=4)}
    cases = {}
    for label in shapes:
        where, nm, ops, dtype = GENERAL_SHAPES[label]
        layer, n1, e1 = layers[where]
        cn = (nm, ops, cs.OFFSET)

        def make(f, seed, n1=n1, e1=e1, layer=layer, nm=nm, dtype=dtype):
            return cs.list_state(f, n1, e1, 256, nm, layer[0], layer[1],
                                 "decoder", seed, dtype)
        small = make(4, 9)
        want = [x.clone() for x in small[:4]]
        listcn.list_layer_plain(*want, small[4], *layer, *cn)
        torch.cuda.synchronize()
        cases[label] = (layer, cn, lambda make=make: make(128, 8)[:4], small,
                        want)
        torch.cuda.empty_cache()
    return cases


def list_main(names) -> int:
    """Time the list kernel's variants ``names`` (see the module
    docstring); with ``--general`` on the general step's shapes
    (GENERAL_SHAPES, or those ``--shapes a,b`` names)."""
    file = "list_checknode.cu"
    base = os.path.join(_build.CSRC, file)
    general = names[:1] == ["--general"]
    if general:
        names = names[1:]
    shapes = list(GENERAL_SHAPES)
    if names[:1] == ["--shapes"]:
        shapes, names = names[1].split(","), names[2:]
    if names[:1] == ["--source"]:
        base, names = names[1], names[2:]
    unknown = [n for n in names if n.split("@")[0] not in LIST_VARIANTS]
    if unknown:
        raise SystemExit(f"FAIL: unknown list variants {unknown}")
    sources = {}
    for path in {base} | {n.split("@", 1)[1] for n in names if "@" in n}:
        with open(path) as f:
            sources[path] = f.read()
    # by default every variant that applies to this source
    names = names or [n for n in LIST_VARIANTS
                      if applies(n, LIST_VARIANTS, sources[base])]
    print(f"variants of {base}", flush=True)
    with tempfile.TemporaryDirectory() as root:
        paths = {}
        for i, n in enumerate(names):
            name, _, path = n.partition("@")
            src = variant_source(name, LIST_VARIANTS, sources[path or base],
                                 os.path.join(root, str(i)), file)
            paths[n] = src
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            built = {n: pool.submit(_build.build, "list_checknode", True,
                                    paths[n]) for n in names}
            built = {n: fut.result() for n, fut in built.items()}
    for n, (_, seconds, log) in built.items():
        print(f"built {n} in {seconds:.1f} s; " + "; ".join(
            f"{k}: {v}" for k, v in entry_reports(log).items()), flush=True)

    def bind(path):
        lib_path = path
        return functools.lru_cache(None)(
            lambda: cuda_list._bind(lib_path))

    graph = DeviceGraph.from_code(random_regular(8100, 4050, 256, dv=2,
                                                 seed=0))
    if general:
        return list_general_main(names, built, bind, graph, shapes)
    p = _layer_plan(graph, "cuda")[0]
    layer = (p["cols32"], p["edge_ids32"], p["rc_in"], p["rc_out"],
             p["valid"])
    modes = {"": (cs.LIST_NM, cs.LIST_OPS, cs.OFFSET),   # the staircase
             "exact ": (cs.LIST_NM, 0, cs.OFFSET)}
    active = torch.ones(128, dtype=torch.bool, device="cuda")
    states = {key: cs.list_state(128, graph.code.n + 1, graph.n_edges + 1,
                                 256, cs.LIST_NM, p["cols"], p["edge_ids"],
                                 "decoder", 7, dtype)[:4]
              for key, dtype in (("bf16", cs.BF16), ("f32", torch.float32))}
    want = {}
    for mode, cn in modes.items():
        for key, state in states.items():
            want[mode + key] = [x.clone() for x in state]
            listcn.list_layer_plain(*want[mode + key], active, *layer, *cn)
    exact, times = {}, collections.defaultdict(list)
    for order in (names, names[::-1]):
        for name in order:
            cuda_list._lib = bind(built[name][0])
            t, ok = [], True
            for mode, cn in modes.items():
                for key, state in states.items():
                    got = [x.clone() for x in state]
                    cuda_list.list_layer(*got, active, *layer, *cn)
                    torch.cuda.synchronize()
                    ok = ok and all(torch.equal(a[:, :-1], b[:, :-1])
                                    for a, b in zip(got, want[mode + key]))
                    t.append(cs.time_ms(lambda: cuda_list.list_layer(
                        *got, active, *layer, *cn), REPS))
                    del got
            exact[name] = ok
            times[name].append(t)
    for name in names:
        cols = list(zip(*times[name]))
        print(f"{name:16s} {list_kind(name):10s} list_layer F=128 "
              "bf16 " + " / ".join(f"{v:.4f}" for v in cols[0])
              + " ms, f32 " + " / ".join(f"{v:.4f}" for v in cols[1])
              + " ms; exact (nbOper = 0) bf16 "
              + " / ".join(f"{v:.4f}" for v in cols[2])
              + " ms, f32 " + " / ".join(f"{v:.4f}" for v in cols[3])
              + f" ms; bit-exact vs plain {exact[name]}", flush=True)
    for name in names:
        if list_kind(name) == "design" and not exact[name]:
            raise SystemExit(f"FAIL: design variant {name} disagrees with "
                             f"the plain version")
    print(cs.card_line())
    print(json.dumps({"list_variants": {n: {
        "kind": list_kind(n),
        "list_layer_bf16_ms": [t[0] for t in times[n]],
        "list_layer_f32_ms": [t[1] for t in times[n]],
        "exact_bf16_ms": [t[2] for t in times[n]],
        "exact_f32_ms": [t[3] for t in times[n]],
        "bit_exact": exact[n]} for n in names}}))
    return 0


def list_general_main(names, built, bind, graph, shapes) -> int:
    """``list_main`` on the general step's shapes: each variant checked
    against the plain version on 4 frames of each shape, then timed at
    F = 128 in turns, forward then backward."""
    cases = general_cases(graph, shapes)
    active = torch.ones(128, dtype=torch.bool, device="cuda")
    exact, times = {}, collections.defaultdict(list)
    for order in (names, names[::-1]):
        for name in order:
            cuda_list._lib = bind(built[name][0])
            t, ok = [], True
            for label in shapes:
                layer, cn, big, small, want = cases[label]
                got = [x.clone() for x in small[:4]]
                cuda_list.list_layer(*got, small[4], *layer, *cn)
                torch.cuda.synchronize()
                ok = ok and all(torch.equal(a[:, :-1], b[:, :-1])
                                for a, b in zip(got, want))
                got = big()
                t.append(cs.time_ms(lambda: cuda_list.list_layer(
                    *got, active, *layer, *cn), GENERAL_REPS))
                del got
                torch.cuda.empty_cache()
            exact[name] = ok
            times[name].append(t)
    for name in names:
        cols = list(zip(*times[name]))
        print(f"{name:24s} {list_kind(name):10s} F=128 " + "; ".join(
            f"{label} " + " / ".join(f"{v:.4f}" for v in cols[i])
            for i, label in enumerate(shapes))
            + f" ms; bit-exact vs plain {exact[name]}", flush=True)
    for name in names:
        if list_kind(name) == "design" and not exact[name]:
            raise SystemExit(f"FAIL: design variant {name} disagrees with "
                             f"the plain version")
    print(cs.card_line())
    print(json.dumps({"list_general_variants": {n: dict(
        {label: [t[i] for t in times[n]] for i, label in enumerate(shapes)},
        kind=list_kind(n), bit_exact=exact[n]) for n in names}}))
    return 0


CN_VARIANTS = {  # name -> (kind, substitutions, each of every occurrence)
    "committed": ("design", []),
    # the dense merges' minima by FMNMX on every row, not two candidates a
    # three-input integer minimum on rows with no negative input
    "fmnmx": ("design", [("constexpr bool INT_MIN3 = true;",
                          "constexpr bool INT_MIN3 = false;")]),
    # every lane reading its chunks' 16-byte halves in one order (2-way
    # bank conflicts in the lanes' loads and stores at q = 256)
    "one_half_order": ("design", [("  const int hl = PER == 8 ? lo & 4 : 0;",
                                   "  const int hl = 0;")]),
    # one or four chunks a loop step, not two
    "unroll_1": ("design", [("constexpr int DENSE_UNROLL = 2;",
                             "constexpr int DENSE_UNROLL = 1;")]),
    "unroll_4": ("design", [("constexpr int DENSE_UNROLL = 2;",
                             "constexpr int DENSE_UNROLL = 4;")]),
    # what the time is spent on (their results are wrong): the dense
    # merges' candidates, the dense prologue (rotate in, truncate, mask,
    # park), the epilogue (rotate out, saturate, normalise, store), both
    "dense_no_merges": ("diagnostic", [
        ("  for (int c = 0; c < nch; ++c) {", "  for (int c = 0; c < 0; ++c) {")]),
    "dense_no_prologue": ("diagnostic", [
        ("      for (int k0 = 0; k0 < (dc > 1 ? dc : 0); k0 += NB) {\n"
         "        const int nb = min(NB, dc - k0);\n        float v[NB][PER];",
         "      for (int k0 = 0; k0 < 0; k0 += NB) {\n"
         "        const int nb = min(NB, dc - k0);\n        float v[NB][PER];")]),
    "no_epilogue": ("diagnostic", [
        ("    for (int k0 = 0; k0 < dc; k0 += NB) {",
         "    for (int k0 = 0; k0 < 0; k0 += NB) {")]),
    "dense_no_edges": ("diagnostic", [
        ("      for (int k0 = 0; k0 < (dc > 1 ? dc : 0); k0 += NB) {\n"
         "        const int nb = min(NB, dc - k0);\n        float v[NB][PER];",
         "      for (int k0 = 0; k0 < 0; k0 += NB) {\n"
         "        const int nb = min(NB, dc - k0);\n        float v[NB][PER];"),
        ("    for (int k0 = 0; k0 < dc; k0 += NB) {",
         "    for (int k0 = 0; k0 < 0; k0 += NB) {")]),
    # the list-driven merges' candidates (the dense mode's too before the
    # dense merge: run as NAME@<that source>), and that form's list stage
    # (the ballot copies of every input and of B[2..dc-1]; the lists are
    # cleared once a warp instead, so that their ids stay in range)
    "list_no_merges": ("diagnostic", [
        ("  for (int j = 0; j < nm; ++j) {", "  for (int j = 0; j < 0; ++j) {")]),
    "list_no_lists": ("diagnostic", [
        ("  const unsigned key_inf = fkey(INF_COST);\n",
         "  const unsigned key_inf = fkey(INF_COST);\n"
         "  for (int i = lane; i < 2 * (dc > 2 ? dc - 2 : 0) * lst; i += 32)\n"
         "    Lst[i] = make_float2(0.0f, 0.0f);\n  __syncwarp();\n"),
        ("        if (m < nb && k >= 1 && k <= L)\n          take_list<PER>(",
         "        if (false)\n          take_list<PER>("),
        ("        if (m < nb)\n          take_list<PER>(key[m], Bs",
         "        if (false)\n          take_list<PER>(key[m], Bs")]),
}
CN_REPS = 10


def cn_entry_reports(log):
    """ptxas' register and spill lines of each ems_rows_kernel instance in
    a verbose build's log, as ``ems_rows_kernel<PER, ws, dense>``."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?ems_rows_kernel"
                      r"ILi(\d)ELb([01])E(?:Lb([01])E)?", line)
        if m:
            name = (f"ems_rows_kernel<{m.group(1)}, ws={m.group(2)}"
                    + (f", dense={m.group(3)}>" if m.group(3) else ">"))
            out[name] = "; ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                if "spill" in x or "registers" in x)
    return out


def sass_histogram(lib_path, kernel="ems_rows_kernelILi8ELb0ELb1E", top=14):
    """The commonest SASS opcodes of one kernel instance of a library
    (``cuobjdump -sass``), or a note where cuobjdump is missing."""
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found"
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300).stdout
    counts, inside = collections.Counter(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", line)
            if m:
                counts[m.group(1)] += 1
    return ", ".join(f"{k} {v}" for k, v in counts.most_common(top))


def cn_main(names) -> int:
    """Time K1's variants ``names``: its dense mode at the layered shape
    (F = 128: [172,800, 4, 256], nm = q, no truncation: the 4k call) and
    from the workspace (dc = 40, 4000 rows, nm = 200), its list mode
    (nm = 32) fused at the layered and flooding shapes, and its bare entry
    on f32 and bf16 rows; each output held against its plain version bit
    for bit.  NAME@PATH: variant NAME of the source at PATH, in the same
    turns; ``--sass`` first prints the SASS opcode counts of each built
    library's dense shared-memory instance at q = 256."""
    sass = names[:1] == ["--sass"]
    names = names[1:] if sass else names
    file = "fb_checknode.cu"
    base = os.path.join(_build.CSRC, file)
    unknown = [n for n in names if n.split("@")[0] not in CN_VARIANTS]
    if unknown:
        raise SystemExit(f"FAIL: unknown K1 variants {unknown}")
    sources = {}
    for path in {base} | {n.split("@", 1)[1] for n in names if "@" in n}:
        with open(path) as f:
            sources[path] = f.read()
    names = names or [n for n in CN_VARIANTS
                      if applies(n, CN_VARIANTS, sources[base])]
    with tempfile.TemporaryDirectory() as root:
        paths = {}
        for i, n in enumerate(names):
            name, _, path = n.partition("@")
            paths[n] = variant_source(name, CN_VARIANTS,
                                      sources[path or base],
                                      os.path.join(root, str(i)), file)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            built = {n: pool.submit(_build.build, "fb_checknode", True,
                                    paths[n]) for n in names}
            built = {n: fut.result() for n, fut in built.items()}
    for n, (lib, seconds, log) in built.items():
        print(f"built {n} in {seconds:.1f} s; " + "; ".join(
            f"{k}: {v}" for k, v in cn_entry_reports(log).items()),
            flush=True)
        if sass:
            print(f"  SASS of {n}: {sass_histogram(lib)}", flush=True)
    graph = DeviceGraph.from_code(random_regular(8100, 4050, 256, dv=2,
                                                 seed=0))
    layer = _layer_plan(graph, "cuda")[0]
    rows = _cn_row_tables(graph, "cuda")
    lt = (layer["rot_in8"], layer["rot_out8"], layer["valid"])
    ft = (rows["rot_in"], rows["rot_out"], rows["valid"])
    wt = cs.odd_tables(40, 40, 256, seed=77)
    xl = cs.rows_input(128 * cs.SLICE_ROWS, 4, 256, "uniform", seed=9)
    xf = cs.rows_input(128 * cs.CODE_ROWS, 4, 256, "uniform", seed=8)
    xw = cs.rows_input(4000, 40, 256, "uniform", seed=10)
    vr = cs.kernel_input(128 * cs.SLICE_ROWS, 4, 256, 32, "uniform", seed=11)
    vb = vr.to(cs.BF16)
    calls = {  # label -> (kernel call, plain call)
        "dense layered": (
            lambda: cuda_cn.ems_rows(xl, *lt, 256, cs.OFFSET, False,
                                     dense=True),
            lambda: cuda_cn.ems_rows_plain(xl, *lt, 256, cs.OFFSET, False,
                                           dense=True)),
        "dense workspace dc=40": (
            lambda: cuda_cn.ems_rows(xw, *wt, 200, cs.OFFSET, True,
                                     dense=True),
            lambda: cuda_cn.ems_rows_plain(xw, *wt, 200, cs.OFFSET, True,
                                           dense=True)),
        "list layered": (
            lambda: cuda_cn.ems_rows(xl, *lt, 32, cs.OFFSET, True),
            lambda: cuda_cn.ems_rows_plain(xl, *lt, 32, cs.OFFSET, True)),
        "list flooding": (
            lambda: cuda_cn.ems_rows(xf, *ft, 32, cs.OFFSET, True),
            lambda: cuda_cn.ems_rows_plain(xf, *ft, 32, cs.OFFSET, True)),
        "bare f32": (lambda: cuda_cn.fb_checknode(vr, 32),
                     lambda: cs.fb_checknode_topk(vr, 32)),
        "bare bf16": (lambda: cuda_cn.fb_checknode(vb, 32),
                      lambda: cs.fb_checknode_topk(vb, 32)),
    }
    want = {}
    for label, (_, plain) in calls.items():
        want[label] = plain()
        torch.cuda.synchronize()
    exact, times = {}, collections.defaultdict(list)
    for order in (names, names[::-1]):
        for name in order:
            cuda_cn._lib = functools.lru_cache(None)(
                functools.partial(cuda_cn._bind, built[name][0]))
            t, ok = [], {}
            for label, (kernel, _) in calls.items():
                got = kernel()
                torch.cuda.synchronize()
                ok[label] = torch.equal(got, want[label])
                del got
                t.append(cs.time_ms(kernel, CN_REPS))
            print(f"{name}: ran, bit-exact vs plain {all(ok.values())}; "
                  + ", ".join(f"{label} {v:.4f}" for label, v in
                              zip(calls, t)) + " ms", flush=True)
            exact[name] = ok
            times[name].append(t)
    for name in names:
        cols = list(zip(*times[name]))
        print(f"{name:28s} {cn_kind(name):10s} " + "; ".join(
            f"{label} " + " / ".join(f"{v:.4f}" for v in col) + " ms"
            for label, col in zip(calls, cols))
            + "; bit-exact vs plain " + ", ".join(
                label for label, ok in exact[name].items() if ok),
            flush=True)
    for name in names:
        if cn_kind(name) == "design" and not all(exact[name].values()):
            raise SystemExit(f"FAIL: design variant {name} disagrees with "
                             f"the plain version: {exact[name]}")
    print(cs.card_line())
    print(json.dumps({"cn_variants": {n: {
        "kind": cn_kind(n),
        **{label.replace(" ", "_").replace("=", "") + "_ms":
           [t[i] for t in times[n]] for i, label in enumerate(calls)},
        "bit_exact": exact[n]} for n in names}}))
    return 0


def cn_kind(label):
    """The kind of the K1 variant a label (NAME or NAME@PATH) names."""
    return CN_VARIANTS[label.split("@")[0]][0]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this run needs a "
              "CUDA card", file=sys.stderr)
        return 1
    if argv[:1] == ["--syndrome"]:
        return syndrome_main(argv[1:])
    if argv[:1] == ["--bubble"]:
        return bubble_main(argv[1:])
    if argv[:1] == ["--list"]:
        return list_main(argv[1:])
    if argv[:1] == ["--cn"]:
        return cn_main(argv[1:])
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
