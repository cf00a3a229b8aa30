"""A cell of ``BENCHMARK.json`` with its configuration and traffic files.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name ``BENCHMARK.json`` gives:
``simbench/configs/<config>.json`` (the file the configuration entry
names), ``simbench/traffic/<traffic>.json`` and
``simbench/metrics/<metric>.py``.
"""
from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "simbench")


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` as a dict: its entry, ``config`` (the parsed
    configuration file), ``traffic`` (the parsed traffic file), and the
    ``end_to_end`` and ``per_layer`` metrics that it reports."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = load_json(os.path.join(root, "simbench", "traffic",
                                     f"{entry['traffic']}.json"))
    if traffic.get("ranks", 1) != entry["chips"]:
        raise ValueError(f"cell {name}: traffic {entry['traffic']} runs "
                         f"{traffic.get('ranks', 1)} ranks, the cell asks "
                         f"for {entry['chips']} chips")

    def reports(metric):
        return name in metric.get("workloads", [name])

    return dict(entry, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])
