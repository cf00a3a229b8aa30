"""The port's Monte-Carlo chain on the CPU against the JAX package's.

The two packages draw different random streams (jax threefry keys vs
torch generators), so the chains agree in distribution: the FER Wilson
95% intervals must overlap.  At 8 dB every frame must decode, almost all
at the first syndrome check."""
import pytest

from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.sim.mc import MonteCarlo as JMonteCarlo
from ems_nbldpc_tpu.sim.mc import SimConfig as JSimConfig

from ems_nbldpc_torch.decoder.api import DecoderConfig
from ems_nbldpc_torch.models.code import from_jax_code
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig, config_key
from ems_nbldpc_torch.utils.stats import overlapping

DEC = dict(max_iters=10, schedule="layered", cn="ems", nm=8, offset=0.3,
           loop="host")


def run_both(ebn0, f=64, frames=128):
    jc = jrandom_regular(96, 48, 16, seed=0)
    jres = JMonteCarlo(jc, JSimConfig(
        ebn0_db=ebn0, frames_per_batch=f, max_frames=frames,
        stop_errors=10**9, decoder=JConfig(cn_impl="topk", **DEC))).run()
    cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=f, max_frames=frames,
                    stop_errors=10**9,
                    decoder=DecoderConfig(cn_impl="pallas", **DEC))
    tres = MonteCarlo(from_jax_code(jc), cfg, device="cpu").run()
    return jres, tres


def test_fer_ci_overlaps_jax():
    jres, tres = run_both(2.0)
    assert tres.frames == jres.frames == 128
    assert 0 < tres.frame_errors < tres.frames      # an informative point
    assert overlapping(tres.frame_errors, tres.frames,
                       jres.frame_errors, jres.frames), (
        tres.fer_ci, jres.fer_ci)
    assert 1 < tres.avg_iters < 10
    # two batches: the host loop ran max(iters) steps in each
    assert tres.avg_iters * tres.frames <= tres.decoder_steps * 64
    assert tres.decoder_steps <= 2 * 10


def test_high_snr_decodes_everything():
    _, tres = run_both(8.0)
    assert tres.frame_errors == tres.bit_errors == 0
    assert tres.avg_iters <= 1
    d = tres.to_dict()
    assert d["fer"] == 0.0 and d["fer_ci"][0] == 0.0
    assert d["config_key"] == config_key(tres.config)


def test_stop_rule_and_zero_codeword():
    jc = jrandom_regular(96, 48, 16, seed=0)
    cfg = SimConfig(ebn0_db=-2.0, frames_per_batch=16, max_frames=10**6,
                    stop_errors=20, encode="zero",
                    decoder=DecoderConfig(cn_impl="topk", **DEC))
    res = MonteCarlo(from_jax_code(jc), cfg, device="cpu").run()
    # stops after the batch that reached 20 erroneous frames
    assert 20 <= res.frame_errors <= res.frames < 20 + 16 + 16
    assert res.undetected_errors <= res.frame_errors


def test_monte_carlo_needs_a_device():
    jc = jrandom_regular(96, 48, 16, seed=0)
    cfg = SimConfig(ebn0_db=2.0, decoder=DecoderConfig(cn_impl="topk", **DEC))
    with pytest.raises(TypeError):
        MonteCarlo(from_jax_code(jc), cfg)       # no CPU fallback
    assert MonteCarlo(from_jax_code(jc), cfg, None, device="cpu").device.type \
        == "cpu"


def test_config_key_names_every_result_knob():
    a = SimConfig(ebn0_db=1.0)
    assert config_key(a) == config_key(SimConfig(ebn0_db=2.0,
                                                 frames_per_batch=7))
    for change in (dict(stop_errors=3), dict(encode="zero"),
                   dict(fake_bch_t=12),
                   dict(decoder=DecoderConfig(cn_impl="pallas"))):
        assert config_key(a) != config_key(SimConfig(ebn0_db=1.0, **change))


@pytest.mark.parametrize("k,n", [(0, 10), (3, 10), (10, 10), (0, 0)])
def test_wilson_ci_matches_jax(k, n):
    from ems_nbldpc_tpu.utils.stats import wilson_ci as jwilson

    from ems_nbldpc_torch.utils.stats import wilson_ci

    assert wilson_ci(k, n) == jwilson(k, n)
