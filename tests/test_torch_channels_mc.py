"""The port's Monte-Carlo chain over the QAM, 64-APSK and 4-D channels on
the CPU, against the JAX package's, and its CLI and resume on them.

The two packages draw different random streams, so the chains agree in
distribution: the FER Wilson 95% intervals must overlap
(``utils/stats.overlapping``).  The 4-D point is the setting of
``benchmarks/results_r3/CHANNEL_VALIDATION_4D.md``, whose C binary
measured 40/879 frame errors; the port's interval must overlap that one
too.
"""
import json
import os

import pytest

from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.models.channels import ChannelSpec as JSpec
from ems_nbldpc_tpu.models.code import load as jload
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.sim.mc import MonteCarlo as JMonteCarlo
from ems_nbldpc_tpu.sim.mc import SimConfig as JSimConfig
from ems_nbldpc_tpu.sim.mc import config_key as jconfig_key

from ems_nbldpc_torch import cli
from ems_nbldpc_torch.decoder.api import DecoderConfig
from ems_nbldpc_torch.models import tools
from ems_nbldpc_torch.models.channels import ChannelSpec
from ems_nbldpc_torch.models.code import from_jax_code, load
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig, config_key
from ems_nbldpc_torch.sim.sweep import completed_points
from ems_nbldpc_torch.utils.stats import overlapping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UBS = os.path.join(REPO, "benchmarks", "results_r2", "rand48_gf256.ubs")
C_ANCHOR_4D = (40, 879)     # CHANNEL_VALIDATION_4D.md, 12 dB


def run_both(jcode, tcode, snr, channel, decoder, jdecoder, frames, batch):
    common = dict(ebn0_db=snr, frames_per_batch=batch, max_frames=frames,
                  stop_errors=10**9)
    jres = JMonteCarlo(jcode, JSimConfig(
        channel=JSpec(**channel), decoder=JConfig(**jdecoder),
        **common)).run()
    tres = MonteCarlo(tcode, SimConfig(
        channel=ChannelSpec(**channel),
        decoder=DecoderConfig(loop="host", **decoder), **common),
        device="cpu").run()
    print(f"port {tres.frame_errors}/{tres.frames} {tres.fer_ci}, avg_it "
          f"{tres.avg_iters:.3f}; JAX {jres.frame_errors}/{jres.frames} "
          f"{jres.fer_ci}, avg_it {jres.avg_iters:.3f}")
    assert tres.frames == jres.frames == frames
    assert 0 < tres.frame_errors < frames          # an informative point
    assert overlapping(tres.frame_errors, tres.frames, jres.frame_errors,
                       jres.frames)
    assert 1 < tres.avg_iters < decoder["max_iters"]
    return tres


def test_4d_channel_fer_overlaps_jax_and_the_c_binary():
    """rand48_gf256.ubs, 256-QAM 4-D with per-dimension fades and 10%
    receiver-side erasures at 12 dB, list EMS nm = 32, offset 0.3,
    nbOper = 64, compressed bf16, 10 iterations."""
    channel = dict(kind="qam256_4d", ssd=True, erasure_prob=0.1,
                   sigma_convention="snr")
    dec = dict(max_iters=10, schedule="layered", cn="ems", nm=32,
               offset=0.3, nboper=64, storage="compressed",
               dtype="bfloat16")
    tres = run_both(jload(UBS, name=UBS), load(UBS, name=UBS), 12.0,
                    channel, dec, dec, frames=500, batch=500)
    assert overlapping(tres.frame_errors, tres.frames, *C_ANCHOR_4D)


@pytest.mark.parametrize("kind,q,snr,nm", [("qam", 16, 9.0, 8),
                                           ("apsk64", 64, 13.0, 16)])
def test_2d_channel_fer_overlaps_jax(kind, q, snr, nm):
    """random_regular(96, 48, q) under Rayleigh fading: 16-QAM and the
    DVB-S2X 64-APSK, layered EMS (the port through its kernel's CPU path,
    JAX through top-k)."""
    jc = jrandom_regular(96, 48, q, seed=0)
    dec = dict(max_iters=10, schedule="layered", cn="ems", nm=nm,
               offset=0.3)
    run_both(jc, from_jax_code(jc), snr,
             dict(kind=kind, rayleigh=True, sigma_convention="snr"),
             dict(cn_impl="pallas", **dec), dict(cn_impl="topk", **dec),
             frames=256, batch=128)


def test_cli_qam_rayleigh_matches_monte_carlo_and_resumes(tmp_path):
    jc = jrandom_regular(48, 24, 16, seed=3)
    path = str(tmp_path / "code.txt")
    tools.write_ubs(ParsedMatrix(
        jc.n, jc.m_rows, jc.q,
        [jc.row_cols[r, :d] for r, d in enumerate(jc.row_deg)],
        [jc.row_coefs[r, :d] for r, d in enumerate(jc.row_deg)]), path)
    out = tmp_path / "out"
    args = ["--matrix", path, "--channel", "qam", "--rayleigh", "--ebn0",
            "8,10", "--iters", 6, "--nm", 8, "--batch", 16, "--max-frames",
            48, "--out", out, "--device", "cpu", "--quiet"]
    assert cli.main([str(a) for a in args]) == 0
    with open(out / "results.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["ebn0_db"] for r in recs] == [8.0, 10.0]
    code = load(path, name=path)
    for rec in recs:
        cfg = SimConfig(ebn0_db=rec["ebn0_db"], frames_per_batch=16,
                        max_frames=48,
                        channel=ChannelSpec(kind="qam", rayleigh=True,
                                            sigma_convention="snr"),
                        decoder=DecoderConfig(max_iters=6, nm=8))
        res = MonteCarlo(code, cfg, device="cpu").run()
        assert (rec["frames"], rec["frame_errors"], rec["bit_errors"],
                round(rec["avg_iters"] * rec["frames"])) == (
            res.frames, res.frame_errors, res.bit_errors, res.iter_sum)
        assert rec["config_key"] == config_key(cfg)
        assert rec["config_key"].startswith("qam:snr:rot0:ray1:ssd0:er0:ref")
    assert 0 < sum(r["frame_errors"] for r in recs)
    assert completed_points(str(out), code, cfg) == {8.0, 10.0}
    # --resume skips both points: the record does not grow
    assert cli.main([str(a) for a in args] + ["--resume"]) == 0
    with open(out / "results.jsonl") as f:
        assert len(f.readlines()) == 2
    # another channel is another configuration: nothing is skipped
    other = [str(a) for a in args if a != "--rayleigh"] + ["--resume",
                                                          "--ebn0", "10"]
    assert cli.main(other) == 0
    with open(out / "results.jsonl") as f:
        assert len(f.readlines()) == 3


@pytest.mark.parametrize("channel", [
    dict(kind="qam", sigma_convention="snr"),
    dict(kind="qam", sigma_convention="snr", rotated=True),
    dict(kind="qam", sigma_convention="snr", rayleigh=True),
    dict(kind="qam", sigma_convention="snr", ssd=True, labeling="gray"),
    dict(kind="qam", sigma_convention="snr", erasure_prob=0.1),
    dict(kind="qam", sigma_convention="snr", rayleigh=True,
         erasure_prob=0.05, labeling="v2"),
    dict(kind="apsk64", sigma_convention="snr", rayleigh=True),
    dict(kind="apsk64", sigma_convention="snr", labeling="gray"),
    dict(kind="qam256_4d", sigma_convention="snr", ssd=True,
         erasure_prob=0.1),
    dict(kind="qam256_4d", sigma_convention="snr"),
])
def test_config_key_channel_fragment_matches_jax(channel):
    got = config_key(SimConfig(ebn0_db=1.0, channel=ChannelSpec(**channel)))
    want = jconfig_key(JSimConfig(ebn0_db=1.0, channel=JSpec(**channel)))
    assert got.split("|")[:5] == want.split("|")[:5]
