"""BENCHMARK.json against the contract's shapes, and the files it names."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from simbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["simbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_text():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end":
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text
                    assert "\t" not in text
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metric_keys_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    cell = spec.cell(name)
    cfg = cell["config"]
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cfg["name"] == entry["config"]
    assert cell["chips"] in (1, 4)
    assert cell["traffic"]["channel"] == "bpsk"
    # a pool of at least 8,192 frames, in passes of a few seconds
    assert (cell["traffic"]["pool_batches"] * cfg["frames_per_batch"]
            >= 8192)
    assert set(cfg["check"]) >= {"codewords_wrong", "intrinsic_rel_err",
                                 "decode_differ_pct", "counters_wrong",
                                 "batch_frames_wrong"}
    listed = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert cfg["reduced"] == listed["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["assumed"])
    assert os.path.exists(os.path.join(spec.HERE, "reference",
                                       f"{cfg['reference']}.py"))
    for m in cell["per_layer"]:
        assert os.path.exists(os.path.join(spec.HERE, "metrics",
                                           f"{m['name']}.py"))
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert entry["file"].startswith("simbench/configs/")
    cfg = spec.load_json(os.path.join(spec.ROOT, entry["file"]))
    assert cfg["name"] == entry["name"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert "matrix" in cfg["assumed"]


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_new_cell_and_metric_found_without_edits(tmp_path):
    """A traffic mix, a cell and a per-layer metric added as new files
    (and entries) in a copy are found with no edit of an existing file."""
    shutil.copytree(spec.HERE, tmp_path / "simbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(
        name="spa_row.2p4dB", config="dvbt2_gf256_spa",
        traffic="bpsk_2p4dB", chips=1, why="a new point"))
    bench["per_layer"].append(dict(
        name="steps_per_batch", unit="steps", better="lower",
        source="program_counter", layer="decoder", moves="frames_per_s",
        workloads=["spa_row.2p4dB"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "simbench" / "traffic" / "bpsk_2p4dB.json").write_text(
        json.dumps({"channel": "bpsk", "ebn0_db": 2.4, "ranks": 1}))
    (tmp_path / "simbench" / "metrics" / "steps_per_batch.py").write_text(
        "def read(run):\n"
        "    c = run['counters']\n"
        "    return float(c[:, 5].mean())\n")
    code = (
        "import numpy as np\n"
        "from simbench import spec\n"
        "from simbench.metrics import reader\n"
        "cell = spec.cell('spa_row.2p4dB')\n"
        "assert cell['traffic']['ebn0_db'] == 2.4\n"
        "names = [m['name'] for m in cell['per_layer']]\n"
        "assert 'steps_per_batch' in names, names\n"
        "run = {'counters': np.array([[128, 0, 0, 0, 500, 7],"
        " [128, 0, 0, 0, 400, 5]])}\n"
        "print(reader('steps_per_batch')(run))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "6.0"


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "-m", "simbench.run"]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
