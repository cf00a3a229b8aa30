"""The port's CLI, sweep, matrix registry and matrix tools, against the JAX
package's where both have them.

Everything runs on the CPU (``--device cpu``) on small codes written to
``tmp_path`` with the port's ``tools.write_ubs``.  File names, matrix
files and ``config_key`` fragments must equal the JAX package's exactly;
result lines carry the port's own counts.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.models import tools as jtools
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.models.formats import ParsedMatrix as JParsedMatrix
from ems_nbldpc_tpu.sim.mc import SimConfig as JSimConfig
from ems_nbldpc_tpu.sim.mc import config_key as jconfig_key
from ems_nbldpc_tpu.sim.sweep import result_filename as jresult_filename

from ems_nbldpc_torch import cli
from ems_nbldpc_torch.decoder import api
from ems_nbldpc_torch.decoder.api import DecoderConfig
from ems_nbldpc_torch.models import registry, tools
from ems_nbldpc_torch.models.code import from_parsed, load
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.sim import sweep
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig, config_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parsed(n=48, m=24, q=16, seed=3):
    """The rows of a JAX random code as the port's and JAX's ParsedMatrix."""
    jc = jrandom_regular(n, m, q, seed=seed)
    rows = [jc.row_cols[r, :d].astype(np.int64)
            for r, d in enumerate(jc.row_deg)]
    coefs = [jc.row_coefs[r, :d].astype(np.int64)
             for r, d in enumerate(jc.row_deg)]
    return (ParsedMatrix(n, m, q, rows, coefs),
            JParsedMatrix(n, m, q, rows, coefs), jc)


@pytest.fixture
def matrix(tmp_path):
    path = str(tmp_path / "code.txt")
    tools.write_ubs(parsed()[0], path)
    return path


def run_cli(*args):
    assert cli.main([*map(str, args), "--device", "cpu", "--quiet"]) == 0


def records(out):
    with open(os.path.join(out, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_positional_form_writes_both_result_files(matrix, tmp_path):
    out = tmp_path / "out"
    run_cli(64, 6, matrix, 2.0, 8, 0.3, 0, "--batch", 32, "--out", out)
    (rec,) = records(out)
    assert (rec["frames"], rec["max_iters"], rec["nm"], rec["offset"]) == (
        64, 6, 8, 0.3)
    assert rec["config_key"].count("|") == 5 and rec["decoder_steps"] > 0
    code = load(matrix, name=matrix)
    cfg = SimConfig(ebn0_db=2.0, decoder=DecoderConfig(max_iters=6, nm=8))
    txt = out / sweep.result_filename(code, cfg)
    line = txt.read_text()
    assert line.startswith(" SNR:2.00: \t FER= ") and "avr_it=" in line


def test_flag_form_sweep_and_result_filename_match_jax(matrix, tmp_path):
    out = tmp_path / "out"
    run_cli("--matrix", matrix, "--ebn0", "1.5:2.5:0.5", "--iters", 5,
            "--nm", 8, "--schedule", "flooding", "--cn-impl", "pallas",
            "--batch", 16, "--max-frames", 32, "--stop-errors", 10**6,
            "--out", out)
    recs = records(out)
    assert [r["ebn0_db"] for r in recs] == [1.5, 2.0, 2.5]
    assert all(r["frames"] == 32 and r["schedule"] == "flooding"
               for r in recs)
    _, _, jc = parsed()
    dec = dict(max_iters=5, nm=8, offset=0.3, schedule="flooding")
    want = jresult_filename(jc, JSimConfig(ebn0_db=1.5,
                                           decoder=JConfig(**dec)))
    got = sweep.result_filename(load(matrix),
                                SimConfig(ebn0_db=1.5,
                                          decoder=DecoderConfig(**dec)))
    assert got == want
    assert sorted(os.listdir(out)) == sorted(["results.jsonl", want])
    assert len((out / want).read_text().splitlines()) == 3


def test_cli_run_matches_monte_carlo(matrix, tmp_path):
    """A point of the CLI is ``MonteCarlo.run`` of the same config and seed
    (default loop), counter for counter."""
    out = tmp_path / "out"
    run_cli("--matrix", matrix, "--ebn0", 1.5, "--iters", 6, "--nm", 8,
            "--batch", 16, "--max-frames", 48, "--out", out)
    (rec,) = records(out)
    cfg = SimConfig(ebn0_db=1.5, frames_per_batch=16, max_frames=48,
                    decoder=DecoderConfig(max_iters=6, nm=8))
    res = MonteCarlo(load(matrix, name=matrix), cfg, device="cpu").run()
    assert (rec["frames"], rec["frame_errors"], rec["bit_errors"]) == (
        res.frames, res.frame_errors, res.bit_errors)
    assert round(rec["avg_iters"] * rec["frames"]) == res.iter_sum


def test_cli_bubble_point_matches_monte_carlo_and_jax_key(matrix, tmp_path):
    """A ``--cn-impl bubble --nboper 24`` point of the CLI on a small UBS
    code is ``MonteCarlo.run`` of the same config and seed, counter for
    counter, and its ``config_key`` has JAX's fragments."""
    out = tmp_path / "out"
    run_cli("--matrix", matrix, "--ebn0", 1.5, "--iters", 6, "--nm", 8,
            "--cn-impl", "bubble", "--nboper", 24, "--batch", 16,
            "--max-frames", 32, "--out", out)
    (rec,) = records(out)
    dec = dict(max_iters=6, nm=8, cn_impl="bubble", nboper=24)
    cfg = SimConfig(ebn0_db=1.5, frames_per_batch=16, max_frames=32,
                    decoder=DecoderConfig(**dec))
    res = MonteCarlo(load(matrix, name=matrix), cfg, device="cpu").run()
    assert (rec["frames"], rec["frame_errors"], rec["bit_errors"]) == (
        res.frames, res.frame_errors, res.bit_errors)
    assert round(rec["avg_iters"] * rec["frames"]) == res.iter_sum
    assert rec["config_key"] == config_key(cfg)
    jcfg = JSimConfig(ebn0_db=1.5, frames_per_batch=16, max_frames=32,
                      decoder=JConfig(**dec))
    got, want = config_key(cfg).split("|"), jconfig_key(jcfg).split("|")
    assert got[:5] == want[:5] and got[-1] == want[-1]
    assert ":bubble:" in got[1] and ":op24:" in got[1]


def test_resume_skips_exactly_the_recorded_points(matrix, tmp_path):
    out = tmp_path / "out"
    common = ("--matrix", matrix, "--iters", 4, "--nm", 8, "--batch", 16,
              "--max-frames", 16, "--out", out)
    run_cli(*common, "--ebn0", "1.0,2.0")
    run_cli(*common, "--ebn0", "1.0,1.5,2.0", "--resume")
    assert [r["ebn0_db"] for r in records(out)] == [1.0, 2.0, 1.5]
    # another key (budget): nothing is skipped
    run_cli(*common[:2], "--iters", 5, *common[4:], "--ebn0", "1.0,2.0",
            "--resume")
    assert [r["ebn0_db"] for r in records(out)] == [1.0, 2.0, 1.5, 1.0, 2.0]
    code = load(matrix, name=matrix)
    base = SimConfig(ebn0_db=0.0, frames_per_batch=16, max_frames=16,
                     decoder=DecoderConfig(max_iters=4, nm=8))
    assert sweep.completed_points(str(out), code, base) == {1.0, 1.5, 2.0}
    syn = dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, cn="syndrome"))
    assert sweep.completed_points(str(out), code, syn) == set()


@pytest.mark.parametrize("decoder", [
    dict(), dict(cn="syndrome"), dict(cn="syndrome", syn_d=(30, 10, 5)),
    dict(cn="syndrome", syn_sat="median", syn_bayes=False),
    dict(schedule="flooding", cn="spa", nboper=7, storage="dense"),
])
def test_config_key_matches_jax_fragments(decoder):
    """The channel and decoder fragments of ``config_key`` equal JAX's
    character for character, the ``syn_*`` fields included; the JAX key
    adds its lowering knobs, which the port does not have."""
    cfg = SimConfig(ebn0_db=1.0, decoder=DecoderConfig(**decoder))
    jcfg = JSimConfig(ebn0_db=1.0, decoder=JConfig(**decoder))
    got, want = config_key(cfg).split("|"), jconfig_key(jcfg).split("|")
    assert got[:5] == want[:5]
    assert got[-1] == want[-1]
    if decoder.get("cn") == "syndrome":
        assert ":syn" in got[1]


def test_config_key_tells_syndrome_settings_apart():
    base = DecoderConfig(cn="syndrome")
    keys = {config_key(SimConfig(ebn0_db=1.0, decoder=dataclasses.replace(
        base, **change))) for change in (
            {}, dict(syn_ncv=40), dict(syn_d=(40, 15, 4)),
            dict(syn_shape="rect"), dict(syn_max_configs=500),
            dict(syn_bayes=False), dict(syn_presort=False),
            dict(syn_sat="median"))}
    assert len(keys) == 8


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("loop", ["device", "host"])
def test_decode_passes_nboper_on_dense_routes(monkeypatch, schedule, loop):
    seen = {}

    def record(g, intrinsic, max_iters, **kw):
        seen.update(kw)
        return "decoded"

    name = {("layered", "device"): "decode_layered",
            ("layered", "host"): "decode_layered_hostloop",
            ("flooding", "device"): "decode_flooding",
            ("flooding", "host"): "decode_flooding_hostloop"}[schedule, loop]
    monkeypatch.setattr(api, name, record)
    code = from_parsed(parsed()[0], name="small")
    cfg = DecoderConfig(schedule=schedule, loop=loop, nm=8, nboper=37)
    assert api.decode(code, torch.zeros((2, code.n, code.q)), cfg) == "decoded"
    assert seen["nboper"] == 37 and seen["nm"] == 8


@pytest.mark.parametrize("writer", ["write_ubs", "write_alist"])
def test_matrix_writers_match_jax_byte_for_byte(tmp_path, writer):
    port, jax_parsed, _ = parsed(40, 20, 64, seed=5)
    getattr(tools, writer)(port, str(tmp_path / "port"))
    getattr(jtools, writer)(jax_parsed, str(tmp_path / "jax"))
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    # and the file reads back as the same code
    code = load(str(tmp_path / "port"))
    assert code.n == 40 and code.m_rows == 20 and code.q == 64


def test_tools_convert_and_dense_roundtrip(tmp_path):
    port = parsed()[0]
    tools.write_alist(port, str(tmp_path / "a.alist"))
    back = tools.convert(str(tmp_path / "a.alist"), str(tmp_path / "b.txt"))
    np.testing.assert_array_equal(tools.to_dense(back), tools.to_dense(port))
    again = tools.from_dense(tools.to_dense(port), port.q)
    np.testing.assert_array_equal(tools.to_dense(again), tools.to_dense(port))
    r, c, v = tools.to_coo(port)
    assert len(r) == len(c) == len(v) == sum(len(x) for x in port.row_cols)


def test_registry_resolves_paths_and_names(tmp_path, monkeypatch, matrix):
    assert registry.matrix_path(matrix) == matrix
    monkeypatch.setattr(registry, "DEFAULT_DIRS", ("", str(tmp_path)))
    assert registry.matrix_path("code") == str(tmp_path / "code.txt")
    assert registry.matrix_path("code.txt") == str(tmp_path / "code.txt")
    assert registry.available() == ["code.txt"]
    assert registry.get_code("code").n == 48
    with pytest.raises(FileNotFoundError):
        registry.matrix_path("no_such_matrix")


def test_unported_sweep_options_raise(matrix, tmp_path):
    # frame sharding is ported (tests/test_torch_mesh.py); asking for more
    # cards than are visible raises before any rank starts
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"only {n - 1} cuda device"):
        cli.main(["--matrix", matrix, "--ebn0", "1.0", "--devices", str(n),
                  "--out", str(tmp_path)])
    assert not os.path.exists(tmp_path / "results.jsonl")
    assert cli.main(["--matrix", matrix]) == 2          # no --ebn0
    assert cli.main(["1", "2", "3"]) == 2               # short positional


def test_cli_module_runs_without_jax(matrix, tmp_path):
    """``python -m ems_nbldpc_torch.cli`` in a fresh process never imports
    jax or the JAX package."""
    script = (
        "import sys, runpy\n"
        "sys.argv = ['cli', '--matrix', sys.argv[1], '--ebn0', '2.0', "
        "'--nm', '8', '--iters', '4', '--batch', '16', '--max-frames', "
        "'16', '--device', 'cpu', '--quiet', '--out', sys.argv[2]]\n"
        "try:\n"
        "    runpy.run_module('ems_nbldpc_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'ems_nbldpc_tpu')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, matrix,
                           str(tmp_path / "out")], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert len(records(tmp_path / "out")) == 1


def test_cli_asks_for_the_card_by_default(matrix, tmp_path):
    """Without ``--device`` the CLI runs on the card; with no card it
    fails rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["--matrix", matrix, "--ebn0", "1.0", "--nm", "8",
                  "--batch", "4", "--max-frames", "4", "--quiet",
                  "--out", str(tmp_path)])
