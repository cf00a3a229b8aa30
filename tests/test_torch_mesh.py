"""Frame sharding over ``torch.distributed`` (``parallel/mesh.py``) on the
CPU: gloo ranks started with ``parallel.mesh.launch``.

Three spawns, each under a rendezvous / collective timeout and a join
timeout, so that a hang fails the test instead of using up the suite's
clock:
* a 2-rank world: the sharded counters equal sequential single-process
  steps on the shards' streams exactly (a dropped reduction fails it);
  one step object gives fewer frame errors at 4 dB than at 0.5 dB;
  compressed list EMS on GF(256) runs sharded; a sharded sweep writes its
  results once and resumes; a run whose FER Wilson interval must overlap
  JAX's ``run_sharded`` on the same code and config;
* a 4-rank world: the 2 x 2 ``make_mesh_2d`` gives the 1-D mesh's totals;
* the CLI with ``--device cpu --devices 2``: it writes its result once
  and resumes a point recorded by an in-process ``--devices 1`` run.
``_shardable``'s rewrite and the too-many-devices errors run in-process.
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.parallel.mesh import _shardable as j_shardable
from ems_nbldpc_tpu.parallel.mesh import make_mesh as jmake_mesh
from ems_nbldpc_tpu.parallel.mesh import run_sharded as jrun_sharded
from ems_nbldpc_tpu.sim.mc import SimConfig as JSimConfig

from ems_nbldpc_torch import cli
from ems_nbldpc_torch.decoder.api import DecoderConfig
from ems_nbldpc_torch.models import tools
from ems_nbldpc_torch.models.code import random_regular
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.parallel import mesh as pmesh
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig
from ems_nbldpc_torch.sim.sweep import run_sweep
from ems_nbldpc_torch.utils.stats import overlapping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60.0          # rendezvous and each collective
JOIN = 180.0            # a whole spawn
FLOOD = dict(max_iters=8, schedule="flooding", cn="minsum")
CI_CFG = dict(ebn0_db=1.5, frames_per_batch=32, max_frames=256,
              stop_errors=10**9)


def small_code():
    return random_regular(48, 24, 16, seed=3)


def launch(n, fn, *args):
    """``parallel.mesh.launch`` on the CPU, one torch thread a rank (the
    suite runs in parallel workers)."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        pmesh.launch(n, fn, args, devices="cpu", timeout=TIMEOUT,
                     join_timeout=JOIN)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


def world2(out, tmp):
    """Each rank of the 2-rank world; rank 0 records what the tests
    check in ``out`` (JSON)."""
    mesh = pmesh.make_mesh(2, devices="cpu")
    code = small_code()
    rec = {"mesh": [mesh.world, mesh.rank, str(mesh.device)]}
    cfg = SimConfig(ebn0_db=1.5, frames_per_batch=32, max_frames=256,
                    stop_errors=10**9, decoder=DecoderConfig(**FLOOD))
    step = pmesh.sharded_batch_step(code, cfg, mesh)
    rec["sharded"] = step(7).tolist()
    if mesh.rank == 0:
        rec["sequential"] = [
            MonteCarlo(code, cfg, device="cpu", shard=r).step(7)[0].tolist()
            for r in range(mesh.world)]
    lo, hi = (step(0, e).tolist() for e in (0.5, 4.0))
    rec["ebn0"] = [lo, hi]
    big = random_regular(32, 16, 256, dv=2, seed=3)
    comp = SimConfig(ebn0_db=2.2, frames_per_batch=8, max_frames=64,
                     stop_errors=10**9, decoder=DecoderConfig(
                         max_iters=4, schedule="layered", cn="ems", nm=16,
                         offset=0.3, nboper=32, storage="compressed",
                         dtype="bfloat16"))
    r = pmesh.run_sharded(big, comp, mesh)
    rec["compressed"] = [r.frames, r.iter_sum, r.decoder_steps]
    r = pmesh.run_sharded(code, SimConfig(**CI_CFG,
                                          decoder=DecoderConfig(**FLOOD)),
                          mesh)
    rec["ci"] = [r.frames, r.frame_errors]
    base = dataclasses.replace(cfg, max_frames=64)
    first = run_sweep(code, [2.0], base, out_dir=tmp, verbose=False,
                      mesh=mesh, device="cpu")
    again = run_sweep(code, [2.0, 2.5], base, out_dir=tmp, verbose=False,
                      mesh=mesh, resume=True, device="cpu")
    rec["sweep"] = [len(first), [x.config.ebn0_db for x in again],
                    first[0].frames]
    if mesh.rank == 0:
        with open(out, "w") as f:
            json.dump(rec, f)


def world4(out):
    mesh = pmesh.make_mesh_2d(2, 2, devices="cpu")
    cfg = SimConfig(ebn0_db=2.0, frames_per_batch=16,
                    decoder=DecoderConfig(**dict(FLOOD, max_iters=4)))
    two = pmesh.sharded_batch_step_2d(small_code(), cfg, mesh)(0)
    one = pmesh.sharded_batch_step(small_code(), cfg, mesh)(0)
    host, chip = divmod(mesh.rank, 2)
    rec = {"2d": two.tolist(), "1d": one.tolist(), "shape": mesh.shape,
           "ici": dist.get_process_group_ranks(mesh.ici),
           "dcn": dist.get_process_group_ranks(mesh.dcn),
           "where": [host, chip]}
    with open(f"{out}.{mesh.rank}", "w") as f:
        json.dump(rec, f)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    out = str(tmp / "rec.json")
    launch(2, world2, out, str(tmp / "sweep"))
    with open(out) as f:
        rec = json.load(f)
    rec["sweep_dir"] = str(tmp / "sweep")
    return rec


def test_sharded_counters_exactly_match_sequential_shards(two_ranks):
    assert two_ranks["mesh"] == [2, 0, "cpu"]
    sharded, seq = two_ranks["sharded"], np.array(two_ranks["sequential"])
    assert sharded[0] == 64 and sharded[1] > 0      # real errors to drop
    assert (seq[:, 1] > 0).all()
    # five counters summed, the decoder steps the largest shard's
    assert sharded == seq[:, :5].sum(axis=0).tolist() + [seq[:, 5].max()]


def test_sharded_step_ebn0_is_an_argument(two_ranks):
    lo, hi = two_ranks["ebn0"]
    assert lo[0] == hi[0] == 64
    assert lo[1] > hi[1]


def test_sharded_compressed_list_ems_gf256(two_ranks):
    frames, iter_sum, steps = two_ranks["compressed"]
    assert frames == 64 and iter_sum > 0 and 0 < steps <= 4 * 4


def test_sharded_sweep_writes_once_and_resumes(two_ranks):
    n_first, again, frames = two_ranks["sweep"]
    assert n_first == 1 and again == [2.5] and frames == 64
    with open(os.path.join(two_ranks["sweep_dir"], "results.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["ebn0_db"] for x in lines] == [2.0, 2.5]
    (txt,) = [n for n in os.listdir(two_ranks["sweep_dir"])
              if n.endswith(".txt")]
    with open(os.path.join(two_ranks["sweep_dir"], txt)) as f:
        assert len(f.readlines()) == 2


def test_sharded_fer_ci_overlaps_jax(two_ranks):
    jc = jrandom_regular(48, 24, 16, seed=3)
    jres = jrun_sharded(jc, JSimConfig(**CI_CFG, decoder=JConfig(**FLOOD)),
                        jmake_mesh(8))
    frames, errors = two_ranks["ci"]
    assert frames == jres.frames == 256
    assert 0 < errors < frames
    assert overlapping(errors, frames, jres.frame_errors, jres.frames), (
        errors, jres.frame_errors)


def test_2d_mesh_equals_1d(tmp_path):
    out = str(tmp_path / "rec")
    launch(4, world4, out)
    recs = []
    for r in range(4):
        with open(f"{out}.{r}") as f:
            recs.append(json.load(f))
    for r, rec in enumerate(recs):
        assert rec["2d"] == rec["1d"] == recs[0]["2d"]
        assert rec["shape"] == [2, 2] and rec["where"] == list(divmod(r, 2))
        host, chip = divmod(r, 2)
        assert rec["ici"] == [2 * host, 2 * host + 1]
        assert rec["dcn"] == [chip, 2 + chip]
    assert recs[0]["2d"][0] == 16 * 4 and recs[0]["2d"][4] > 0


def test_cli_devices_writes_once_and_resumes(tmp_path):
    jc = small_code()
    rows = [jc.row_cols[r, :d].astype(np.int64)
            for r, d in enumerate(jc.row_deg)]
    coefs = [jc.row_coefs[r, :d].astype(np.int64)
             for r, d in enumerate(jc.row_deg)]
    matrix = str(tmp_path / "code.txt")
    tools.write_ubs(ParsedMatrix(48, 24, 16, rows, coefs), matrix)
    out = str(tmp_path / "out")
    args = ["--matrix", matrix, "--iters", "6", "--nm", "8", "--batch", "32",
            "--max-frames", "64", "--stop-errors", "1000000000",
            "--device", "cpu", "--out", out, "--quiet"]
    # --devices 1: in this process, a world of 1
    assert cli.main(args + ["--ebn0", "2.0", "--devices", "1"]) == 0
    assert not dist.is_initialized()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ems_nbldpc_torch.cli", *args,
         "--ebn0", "2.0,2.5", "--devices", "2", "--resume"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=JOIN)
    assert proc.returncode == 0, proc.stderr
    with open(os.path.join(out, "results.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [(x["ebn0_db"], x["frames"]) for x in lines] == [(2.0, 64),
                                                            (2.5, 64)]
    assert lines[0]["config_key"] == lines[1]["config_key"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread in this process too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_shardable_rewrites_as_jax():
    for dec in (dict(loop="host"), dict(storage="compressed", cn_impl="topk"),
                dict(storage="compressed", cn_impl="topk", loop="host")):
        with pytest.warns(UserWarning, match="sharded execution rewrote"):
            got = pmesh._shardable(SimConfig(ebn0_db=1.0,
                                             decoder=DecoderConfig(**dec)))
        with pytest.warns(UserWarning):
            want = j_shardable(JSimConfig(ebn0_db=1.0,
                                          decoder=JConfig(**dec)))
        assert dataclasses.asdict(got.decoder) == dataclasses.asdict(
            want.decoder)
    cfg = SimConfig(ebn0_db=1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pmesh._shardable(cfg) is cfg


def test_too_many_devices_raise():
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"requested a {n}-device mesh but "
                       f"only {n - 1} cuda device"):
        pmesh.make_mesh(n)
    with pytest.raises(ValueError, match=f"only {n - 1} cuda device"):
        pmesh.launch(n, print)
    cores = os.cpu_count()
    with pytest.raises(ValueError, match=f"only {cores} cpu device"):
        pmesh.make_mesh(cores + 1, devices="cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        pmesh.make_mesh(2, devices="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        pmesh.make_mesh(1, devices="meta")


def test_launch_fails_on_a_hung_rank(monkeypatch):
    """``launch`` stops ranks that outlive its join timeout and raises."""
    import torch.multiprocessing as mp

    class Proc:
        killed = False

        def is_alive(self):
            return not self.killed

        def kill(self):
            self.killed = True

    class Context:
        processes = [Proc(), Proc()]

        def join(self, timeout):
            return False

    monkeypatch.setattr(mp, "start_processes", lambda *a, **k: Context())
    with pytest.raises(TimeoutError, match="not done within 0.1 s"):
        pmesh.launch(2, print, devices="cpu", join_timeout=0.1)
    assert all(p.killed for p in Context.processes)
