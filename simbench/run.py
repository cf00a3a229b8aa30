"""Run one cell of ``BENCHMARK.json`` on the card(s) and print its result.

    python -m simbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (the code, the cell's kernels, the
encoder and its upload, the device loop's capture, a warm-up) is counted
from the process's start; then the window runs the program's batch step
for ``--seconds``, to the end of a pass over the traffic's pool; then the
reference checks what the window produced.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics.  The last line of standard output is one JSON object;
the numbers compared for ``correct`` close standard error and the line.
Exits non-zero, with no result, without enough CUDA cards, or if JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()
T0_EPOCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from simbench import spec  # noqa: E402

# every cache the program writes, at fixed paths inside the checkout
CACHE = os.path.join(spec.HERE, ".cache")
CACHE_ENV = {"NBLDPC_TORCH_CACHE_DIR": os.path.join(CACHE, "encoder"),
             "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
             "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions")}


NAME_CHARS = 120           # a kernel or host range name in the breakdown


def p95(values) -> float:
    """The nearest-rank 95th percentile: the smallest value with at least
    95% of the values at or below it."""
    xs = sorted(values)
    return xs[max(0, -(-95 * len(xs) // 100) - 1)]


def end_to_end(rec: dict) -> dict:
    win = rec["window"]
    frames = int(win["counters"][:, 0].sum())
    return dict(frames_per_s=frames / win["window_s"],
                batch_ms_p95=1e3 * p95(win["walls"]),
                peak_mem_gib=rec["peak"] / 2 ** 30,
                setup_s=rec["setup_s"])


def traced_record(rec: dict, config: dict) -> dict:
    win = rec["window"]
    return dict(splits=win["splits"], counters=win["counters"],
                profile=win["profile"], config=config, shape=rec["shape"])


def busy(kernels) -> tuple[float, list]:
    """(seconds some kernel ran, the idle gaps as (start us, end us))."""
    total, end, gaps = 0.0, None, []
    for ts, dur, _ in kernels:
        if end is None or ts > end:
            if end is not None:
                gaps.append((end, ts))
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total / 1e6, gaps


def breakdown(prof: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the host's innermost range at its middle
    (with the harness's span around it)."""
    by_name = {}
    for _, dur, name in prof["kernels"]:
        name = name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    _, gaps = busy(prof["kernels"])
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        around = [(dur, name) for ts, dur, name in prof["host"]
                  if ts <= mid <= ts + dur]
        spans = [n for _, n in sorted(around) if n.startswith("simbench.")]
        inner = min(around)[1] if around else "no host range"
        label = inner if not spans or spans[0] == inner else (
            f"{spans[0]}: {inner}")
        named.append([label[:NAME_CHARS], (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def per_layer(cell: dict, rec: dict) -> dict:
    from simbench.metrics import reader

    run = traced_record(rec, cell["config"])
    out = {}
    for m in cell["per_layer"]:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(cell: dict, recs: list) -> tuple[bool, dict, dict]:
    """(correct, the numbers compared, {name: [number, limit]}) from the
    records of the cell's ranks (rank 0 first)."""
    from simbench import check

    rec0 = recs[0]
    cfg = cell["config"]
    frames = cfg["frames_per_batch"] * len(recs)
    raw = {k: sum(r["raw"][k] for r in recs)
           for k in ("codewords_wrong", "frames", "differ", "counters_wrong")}
    raw["intr_err"] = max(r["raw"]["intr_err"] for r in recs)
    raw["intr_scale"] = max(r["raw"]["intr_scale"] for r in recs)
    numbers = check.finish(raw, rec0["window"]["counters"], frames)
    if len(recs) > 1:
        # the first five counters add up over the ranks, the decoder steps
        # are the largest rank's
        import numpy as np

        want = sum(r["locals"] for r in recs)
        want[:, 5] = np.max([r["locals"][:, 5] for r in recs], axis=0)
        numbers["exchange_wrong"] = int(
            (rec0["window"]["counters"] != want).any(axis=1).sum())
    correct, shown = check.verdict(numbers, cfg["check"])
    return correct, numbers, shown


def result(cell: dict, recs: list, trace: bool) -> tuple[dict, dict]:
    """(the result line, the numbers compared with their limits) from the
    records of the cell's ranks (rank 0 first)."""
    import torch

    rec0 = recs[0]
    frames = cell["config"]["frames_per_batch"] * len(recs)
    correct, numbers, shown = judge(cell, recs)
    peak = max(r["peak"] for r in recs)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": len(recs), "memory_peak_bytes": peak}
    if trace:
        metrics = per_layer(cell, rec0)
        profs = [r["window"]["profile"] for r in recs]
        device["busy_s"] = statistics.mean(busy(p["kernels"])[0]
                                           for p in profs)
        device["window_s"] = rec0["window"]["profile"]["wall_s"]
    else:
        e2e = end_to_end(rec0)
        e2e["peak_mem_gib"] = peak / 2 ** 30
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    attempted = int(rec0["window"]["counters"][:, 0].sum())
    failed = int(numbers["codewords_wrong"] + frames * (
        numbers["counters_wrong"] + numbers["batch_frames_wrong"]))
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = breakdown(rec0["window"]["profile"])
    line["check"] = shown
    return line, shown


def describe(cell: dict, recs: list) -> dict:
    """What an earlier line of standard output says about the run."""
    rec0 = recs[0]
    win = rec0["window"]
    return {"cell": cell["name"], "ranks": len(recs),
            "setup_parts_s": rec0["parts"], "kernel_builds_s": rec0["builds"],
            "batches": len(win["walls"]), "window_s": win["window_s"],
            "batch_ms_median": 1e3 * statistics.median(win["walls"]),
            "graph_pool_bytes": rec0["pool_bytes"],
            "kept_batches": rec0["raw"]["kept_batches"],
            "reference_s": [r["raw"]["reference_s"] for r in recs],
            "splits_queued": [s["queued"] for s in win["splits"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(CACHE_ENV)
    cell = spec.cell(args.workload)
    import torch

    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"simbench: cell {cell['name']} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    trace = bool(args.trace)
    if chips == 1:
        from simbench.cellrun import run_rank

        recs = [run_rank(cell, args.seed, args.seconds, trace, "cuda", T0)]
    else:
        from simbench.sharded import run_ranks

        recs = run_ranks(cell, args.seed, args.seconds, trace, "cuda",
                         T0_EPOCH)
    from simbench.cellrun import forbidden_modules

    found = sorted(set(forbidden_modules()).union(
        *(r["forbidden"] for r in recs)))
    if found:
        print(f"simbench: modules of {found} were loaded; the port's run "
              "must not load JAX or the JAX package", file=sys.stderr)
        return 3
    line, shown = result(cell, recs, trace)
    print(json.dumps(describe(cell, recs)), flush=True)
    for name, (value, limit) in shown.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
